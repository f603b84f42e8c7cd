"""Filter-config layer: jconvolver language and compiler."""

from folve_tpu_torch.filters.compiler import (
    CompiledFilter,
    FilterCompileError,
    compile_config_file,
    compile_spec,
)
from folve_tpu_torch.filters.sstring import sstring
from folve_tpu_torch.filters.zita_parser import (
    ConvolverDecl,
    CopyOp,
    DiracOp,
    FilterSpec,
    HilbertOp,
    ReadOp,
    ZitaConfigError,
    parse_config,
)

__all__ = [
    "CompiledFilter",
    "FilterCompileError",
    "compile_config_file",
    "compile_spec",
    "sstring",
    "ConvolverDecl",
    "CopyOp",
    "DiracOp",
    "FilterSpec",
    "HilbertOp",
    "ReadOp",
    "ZitaConfigError",
    "parse_config",
]
