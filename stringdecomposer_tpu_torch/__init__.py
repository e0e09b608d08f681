"""stringdecomposer-tpu-torch: the PyTorch / CUDA port of stringdecomposer_tpu.

Public API:
    run(...)              — full pipeline, reference-compatible TSV outputs
    decompose_reads(...)  — raw DP stage as a library call
    PipelineConfig        — pipeline knobs (scoring, windowing, batching)
"""

__all__ = ["run", "decompose_reads", "PipelineConfig"]


def __getattr__(name):
    # lazy: importing the package must not pull in torch (e.g. for --help)
    if name in __all__:
        from . import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
