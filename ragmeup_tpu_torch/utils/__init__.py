from ragmeup_tpu_torch.utils.profiling import StageTimer, trace_stage

__all__ = ["StageTimer", "trace_stage"]
