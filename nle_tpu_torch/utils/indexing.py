"""Row-major flatten index math (port of nle_tpu/utils/indexing.py;
reference include/utils.hpp:11-19). Works on ints, NumPy arrays and
integer tensors alike."""


def to_1d_index(row, col, ncols):
    return row * ncols + col


def to_2d_coords(index, ncols):
    return index // ncols, index % ncols
