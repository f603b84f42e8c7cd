"""Filter-config layer: jconvolver language, compiler, discovery."""

from folve_tpu_torch.filters.compiler import (
    CompiledFilter,
    FilterCompileError,
    compile_config_file,
    compile_spec,
)
from folve_tpu_torch.filters.resolve import (
    list_config_dirs,
    resolve_filter_config,
    sanitize_config_subdir,
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
    "list_config_dirs",
    "resolve_filter_config",
    "sanitize_config_subdir",
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
