"""exchange: device ms a rank's load of NCCL's kernels, averaged over the
ranks' loads: the ``all_to_all`` that sends each edge to its owner, and
the ``all_gather``s in which the ranks agree on sizes.  NCCL's time on a
card includes its wait for the other cards."""


def claim(rec, load):
    return rec[0].startswith(("ncclDevKernel", "ncclKernel"))


def read(run):
    return run.device_ms(claim)
