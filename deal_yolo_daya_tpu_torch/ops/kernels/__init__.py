"""Hand-written CUDA kernels (sources in ``csrc/``), each beside its plain
PyTorch version and a launch counter."""


def register_ops() -> None:
    """Register the custom ops ``dyd::area_attention_fwd`` and
    ``dyd::nms_suppress`` (importing their modules does it), as a process
    must before it loads an exported program that holds them."""
    from . import area_attention, nms_suppress  # noqa: F401
