"""Hand-written CUDA kernels for the aggregation path and the training
head, with their plain PyTorch versions.

* :mod:`repro_torch.kernels.segstats`    — segmented statistics (combine)
* :mod:`repro_torch.kernels.blockscan`   — column prefix sums (propagation,
  CMS offsets)
* :mod:`repro_torch.kernels.scatter_add` — scatter-add and the CMS census
* :mod:`repro_torch.kernels.xent`        — the training head's
  cross-entropy on the tensor cores
* :mod:`repro_torch.kernels.ops`         — the composites the path calls
* :mod:`repro_torch.kernels.batch`       — the launch funnel
* :mod:`repro_torch.kernels._build`      — nvcc build, ctypes binding and
  launch counts

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor.
"""
