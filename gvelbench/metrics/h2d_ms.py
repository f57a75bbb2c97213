"""host staging and H2D: device ms a load of the host-to-device copies
that bring the staged batches to the card."""


def claim(rec, load):
    return rec[0].startswith("Memcpy HtoD")


def read(run):
    return run.device_ms(claim)
