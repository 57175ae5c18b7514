"""The port's configuration: the JAX package's config system, imported.

``biom3_tpu.config`` is pure numpy/stdlib (it loads no JAX), so the port
reads the reference JSON configs through it rather than keeping a copy.
"""

from biom3_tpu.config import (  # noqa: F401
    BertConfig,
    Config,
    ESM2Config,
    FacilitatorConfig,
    PenCLConfig,
    ProteoScribeConfig,
    load_json_config,
)
