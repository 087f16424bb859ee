"""PyTorch / CUDA twin of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/X/Y.py`` has a twin at ``repro_torch/X/Y.py``) and holds the
port to the reference in tests that import both. It imports ``torch`` and
numpy only -- never ``jax`` and nothing from ``repro``.

Ported so far: the paper's FEMNIST training run as its users drive it
(``federated.FederatedTrainer`` with the stacked executor, the
virtual-clock scheduler, the wire codec and the ``obs`` slice they use),
on the FedLite train step (``models.paper_models.FemnistCNN`` +
``core.fedlite.make_train_step`` / ``make_weighted_step``) with the
compressed downlink and codebook warm start (``core.compressors``), the
k-means entry point (``core.kmeans``), the paper's text tasks, crash
recovery, run health and autoscaling; and the LM zoo: FedLite split
training (``launch.train``) and split serving (``launch.serve``) of all
ten ``configs`` through ``models.transformer.TransformerLM`` (dense, MoE,
SSM and hybrid blocks, audio codebooks and vision inputs).
Every TPU kernel of the JAX package has its CUDA C++ counterpart for
``sm_90a`` (``csrc/``, built with nvcc at first use and bound with ctypes;
see ``kernels/_build.py``): ``lloyd_update``, ``pq_quantize``,
``kmeans_assign``, ``scalar_quantize``, ``pack_codes`` / ``unpack_codes``
and ``flash_attention``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
On CPU tensors the kernel wrappers compute their plain PyTorch versions
(``kernels/ref.py``); on CUDA tensors they launch the kernel or raise.
"""
