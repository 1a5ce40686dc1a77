from ragmeup_tpu_torch.pipeline.system import RagSystem

__all__ = ["RagSystem"]
