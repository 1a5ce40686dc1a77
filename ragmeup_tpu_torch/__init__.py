"""ragmeup_tpu_torch: the PyTorch and CUDA port of ragmeup_tpu for NVIDIA Hopper.

The package mirrors ``ragmeup_tpu``'s layout (``config``, ``data/``,
``ops/``, ``models/``, ``retrieval/``, ``pipeline/``, ``native/``) and public
names. It imports torch and never jax, nor anything of ``ragmeup_tpu``: the
host-side modules it shares with the JAX package (config, data, the RAG
pipeline and chat backends, the native analyzer) are its own copies. Every
Pallas kernel on the ported paths is a hand-written CUDA kernel for sm_90a
under ``csrc/`` with a plain PyTorch twin beside its wrapper; CPU tensors
take the twin, CUDA tensors launch the kernel. Entry points run on the card
unless they are given ``device="cpu"``.
"""

__version__ = "0.1.0"
from ragmeup_tpu_torch.config import RagConfig, load_config
from ragmeup_tpu_torch.pipeline.system import RagSystem

__all__ = ["RagConfig", "RagSystem", "load_config"]
