"""ragmeup_tpu_torch: the PyTorch and CUDA port of ragmeup_tpu for NVIDIA Hopper.

The package mirrors ``ragmeup_tpu``'s layout (``ops/``, ``models/``,
``retrieval/``, ``pipeline/``) and public names. It imports torch and never
jax: the modules of ``ragmeup_tpu`` it reuses as they are (``config``,
``data``, ``pipeline.rag``, ``pipeline.llm_backends``, ``native``) import no
jax either. Every Pallas kernel on the ported path is a hand-written CUDA
kernel for sm_90a under ``csrc/`` with a plain PyTorch twin beside its
wrapper; CPU tensors take the twin, CUDA tensors launch the kernel.
"""

__version__ = "0.1.0"
