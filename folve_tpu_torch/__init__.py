"""folve_tpu_torch — the folve streaming-convolution engine in PyTorch.

A port of :mod:`folve_tpu` to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).  Public layouts (filter spectra, stream state,
the fused serving carry) are those of the JAX package, so states and
spectra convert one to one (:mod:`folve_tpu_torch.convert`).

``python -m folve_tpu_torch`` is the command line (:mod:`folve_tpu_torch.cli`).
Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of every kernel.
Routing follows the tensor's device: CUDA tensors launch the kernels
(built at first use from ``engine/kernels/csrc``), CPU tensors take the
plain versions.
"""
