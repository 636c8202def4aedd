"""Step graphs (``core/query/step_graph.py``): the share of the window's
batches that a CUDA-graph replay served."""


def read(rec):
    n = rec.delta("batches.replayed")
    return 100.0 * n / rec.batches if n is not None and rec.batches else None
