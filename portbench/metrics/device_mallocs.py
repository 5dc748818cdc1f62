"""Device (H100): the caching allocator's ``cudaMalloc`` calls a step,
the increase in ``num_device_alloc`` over the step that the Trainer puts
on its ``train.step`` span; 0 once the cache holds what a step needs."""
from portbench import spans

UNIT = "count/step"
probe = spans.snapshot


def read(rec):
    return spans.counter(rec, "device_mallocs", "num_device_alloc")
