"""setup_s (s, lower): process start to the first timed request: imports,
the cell's inputs made from the seed and moved to the card, the kernels'
build where the checkout has none yet, and the warm-up.  Every cell."""


def read(m):
    return m.setup_s
