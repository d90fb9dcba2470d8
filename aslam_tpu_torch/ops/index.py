"""Static-shape scatter and compaction helpers, none of which reads the device.

The reference leans on two JAX semantics that torch does not share:

  * an out-of-range scatter index is dropped.  The reference routes every
    masked update to a padding row (index N of an [N, ...] table) and slices
    it off; torch raises on such an index (a device-side assert on the
    card), so `set_rows` appends that row explicitly and drops it after;
  * `jnp.nonzero(mask, size=, fill_value=)` has a static output size.
    `torch.nonzero` syncs the host and returns a data-dependent shape, so
    `nonzero_static` is a prefix sum plus a bounded scatter.

Where several updates of one scatter-set name the same row with different
values, XLA on the CPU applies them in order and the last one wins, while
`index_put_` promises no winner.  `set_rows_last_wins` makes the reference's
order explicit for the few call sites where such collisions occur.

A float scatter-add is the same kind of trap: `index_add_` on the card adds
with atomics, in whatever order the threads arrive, so two runs of one
program differ in the last bits.  `index_add_ordered` sums every target's
rows in one fixed order instead.
"""

from __future__ import annotations

import torch


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """Indices of the first `size` True entries of a 1-D mask, in ascending
    order, padded with `fill_value` -> int64 [size]."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


def _padded(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def set_rows(x: torch.Tensor, idx, vals) -> torch.Tensor:
    """`x.at[idx].set(vals)` out of place, with index x.shape[0] (the
    padding row) dropped.  `idx` is an int64 tensor or a tuple of them
    indexing the leading dims.  Duplicate indices must carry equal values."""
    out = _padded(x)
    if not isinstance(vals, torch.Tensor):
        # a Python value would be copied from host memory, waiting for the
        # stream; a fill on the device does not wait
        vals = torch.full((), vals, dtype=x.dtype, device=x.device)
    out[idx] = vals
    return out[:-1]


def set_rows_last_wins(x: torch.Tensor, idx, vals) -> torch.Tensor:
    """`set_rows` where duplicate indices may carry different values: the
    last update in row-major order of the broadcast index wins, as XLA's
    scatter on the CPU applies them."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    idx = torch.broadcast_tensors(*idx)
    shape = idx[0].shape
    lead = x.shape[:len(idx)]
    key = torch.zeros(shape, dtype=torch.int64, device=x.device)
    for i, d in zip(idx, (x.shape[0] + 1,) + lead[1:]):
        key = key * d + i
    key = key.reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    last_sorted = torch.ones_like(sk, dtype=torch.bool)
    last_sorted[:-1] = sk[1:] != sk[:-1]
    last = torch.empty_like(last_sorted).scatter_(0, order, last_sorted)
    flat = [i.reshape(-1) for i in idx]
    flat[0] = torch.where(last, flat[0], x.shape[0])
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((), vals, dtype=x.dtype, device=x.device)
    vals = vals.expand(shape + x.shape[len(idx):]).reshape(
        (-1,) + x.shape[len(idx):])
    return set_rows(x, tuple(flat), vals)


def _sorted_add(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """`out.index_add_(0, idx, src)` through `index_put_(accumulate=True)`:
    on the card that sorts `idx` stably and adds each target's rows one after
    another in that order, so the bits do not change between runs.  Rows
    where `valid` is False go to scratch rows of their own, one each, and
    are dropped."""
    if valid is None:
        return out.index_put_((idx,), src, accumulate=True)
    rows, n = out.shape[0], idx.shape[0]
    buf = torch.cat([out, out.new_zeros((n,) + out.shape[1:])])
    scratch = torch.arange(rows, rows + n, dtype=idx.dtype, device=idx.device)
    buf.index_put_((torch.where(valid, idx, scratch),), src, accumulate=True)
    return out.copy_(buf[:rows])


def index_add_ordered(out: torch.Tensor, idx: torch.Tensor,
                      src: torch.Tensor,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """`out.index_add_(0, idx, src)` (in place; returns `out`) with every
    target's rows summed in a fixed order on every device, the rows where
    `valid` is False left out.  The CPU's `index_add_` already adds in index
    order; on the card it adds with atomics, so there the sum goes through
    `_sorted_add`.

    The sorted sum walks each target's rows in sequence, so a target named
    by most of the rows (the padding index every masked entry points to)
    would serialise the call: pass `valid` wherever masked rows share an
    index."""
    if out.device.type != "cpu":
        return _sorted_add(out, idx, src, valid)
    if valid is not None:
        idx, src = idx[valid], src[valid]
    return out.index_add_(0, idx, src)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] per leading index: x [*L, N, *R], idx [*L, K] int64 ->
    [*L, K, *R].  With no leading dims it is `x[idx]`; with a batch axis
    each lane gathers from its own rows (a gather, exact)."""
    d = idx.dim() - 1
    rest = x.shape[d + 1:]
    full = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
    return torch.gather(x, d, full)


def take_pixels(img: torch.Tensor, yi: torch.Tensor,
                xi: torch.Tensor) -> torch.Tensor:
    """img[..., yi, xi] per leading index: img [*L, H, W], yi and xi int64
    [*L, *K] -> [*L, *K] (`img[yi, xi]` with no leading dims)."""
    lead = img.shape[:-2]
    flat = (yi * img.shape[-1] + xi).reshape(lead + (-1,))
    return torch.gather(img.flatten(-2), -1, flat).reshape(yi.shape)


def pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor without a host read (a 0-d tensor index
    is read back to the host by torch's indexing)."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]
