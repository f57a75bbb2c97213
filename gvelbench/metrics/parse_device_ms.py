"""parse: device ms a load of the parse kernels (``csrc/parse_edges.cu``)."""

KERNELS = ("parse_accumulate_kernel", "parse_bytes_kernel")


def claim(rec, load):
    return any(k in rec[0] for k in KERNELS)


def read(run):
    return run.device_ms(claim)
