"""Device (H100): the caching allocator's retries a step (a failed
``cudaMalloc``, the cache freed and the call tried again), the increase
in ``num_alloc_retries`` over the step that the Trainer puts on its
``train.step`` span."""
from portbench import spans

UNIT = "count/step"
probe = spans.snapshot


def read(rec):
    return spans.counter(rec, "alloc_retries", "num_alloc_retries")
