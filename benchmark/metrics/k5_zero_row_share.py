"""k5_zero_row_share (program counter), %: the slot rows K5
(csrc/resample_update.cu) stores as zeros without reading them, its
empty rows [n_end, L), over all the slot rows it writes
(``slam_tpu_torch.ops.kernels.kernels.resample_update.rows``: 100 sum
(L - n_end) / sum L over the process's K5 launches, the set-up's
included). None where the program has no such counter or launched no
K5. Layer: kernels."""


def read(ctx):
    from slam_tpu_torch.ops.kernels import kernels
    rows = getattr(kernels.resample_update, "rows", None)
    if rows is None:
        return None
    empty, total = (int(v) for v in rows.tolist())
    return 100.0 * empty / total if total else None
