from repro_torch.data.pipeline import TokenPipeline, make_pipeline

__all__ = ["TokenPipeline", "make_pipeline"]
