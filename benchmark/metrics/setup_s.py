"""``setup_s``: process start to the first timed call (host clock): import,
CUDA initialisation, the kernels' load or build, the inputs, the world's
build and the warm-up of the cell's own shapes."""


def read(window):
    return window.setup_s
