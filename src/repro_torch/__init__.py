"""PyTorch / CUDA twin of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/X/Y.py`` has a twin at ``repro_torch/X/Y.py``) and holds the
port to the reference in tests that import both. It imports ``torch`` and
numpy only -- never ``jax`` and nothing from ``repro``.

Ported so far: the FEMNIST FedLite train step (``models.paper_models.
FemnistCNN`` + ``core.fedlite.make_train_step``), with the grouped product
quantizer and its two TPU kernels (``lloyd_update``, ``pq_quantize``)
rewritten as CUDA C++ for ``sm_90a`` (``csrc/``, built with nvcc at first
use and bound with ctypes; see ``kernels/_build.py``).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
On CPU tensors the kernel wrappers compute their plain PyTorch versions
(``kernels/ref.py``); on CUDA tensors they launch the kernel or raise.
"""
