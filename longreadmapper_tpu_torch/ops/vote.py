"""Top-2 diagonal voting (port of longreadmapper_tpu/ops/vote.py).

Reproduces the reference histogram's semantics exactly:
  - bucket id = key >> 4 (16 bp diagonal quantization);
  - per bucket: vote count, minimum key, first-insertion order;
  - top-2 = max by (count desc, insertion order asc).

One stable sort by bucket carries a packed (pos << 4 | key & 15) payload:
stability puts the run's first insertion at its head, and the run's
minimum key is bucket*16 + min(key & 15), found by a segmented min.
Returns (v1, key1, v2): top-1 count, top-1 bucket's min key, top-2 count.

Keys are int32, or int64 on the pos64 path.  JAX sorts an int64 bucket as
a (hi, lo ^ sign) int32 pair with a (max, max) sentinel; that order is
the signed int64 order and the sentinel is the int64 maximum, so the port
sorts the int64 bucket itself.

`top2_votes` launches the hand-written CUDA kernel
csrc/vote.cu::top2_votes_kernel on a CUDA tensor (one CTA a row sorts its
(bucket, column) pairs in shared memory, or in a global scratch row past
the shared-memory limit; counted in `top2_votes.launches`), and runs the
plain version `top2_votes_plain` on a CPU tensor.  The mapping step votes
through csrc/vote.cu::vote_rows_kernel (ops/seed_vote.py), which ends in
the same code.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build

_ORD_BITS = 27
_SENT = 0x7FFFFFFF
_SENT64 = 0x7FFFFFFFFFFFFFFF


def _top1(count, first_occ, eligible):
    """(count desc, first_occ asc) argmax over dim 1.  Returns (idx, cnt):
    the winner's position and count (0 if none)."""
    c = torch.where(eligible, count, -1)
    cmax = c.amax(dim=1, keepdim=True)
    fo = torch.where(eligible & (count == cmax) & (cmax >= 0),
                     first_occ, _SENT)
    idx = fo.argmin(dim=1)             # first minimum, as jnp.argmin
    cnt = cmax[:, 0].clamp(min=0)
    return idx, cnt


# the C entries of csrc/vote.cu: each takes its argument struct and the
# stream
_P = ctypes.c_void_p
VOTE_FUNCS = {"lrm_seed_tables": [_P, _P], "lrm_vote_rows": [_P, _P],
              "lrm_top2_votes": [_P, _P]}
# dynamic shared memory a row's CTA may take: the card's 227 KB a block
# less room for the kernels' static arrays; a row that needs more sorts in
# a global scratch row
ROW_SMEM = 227 * 1024 - 8 * 1024


class Top2Args(ctypes.Structure):
    """csrc/vote.cu::Top2Args: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("keys", "valid", "v1", "key1", "v2", "scratch")] + [
        (k, ctypes.c_int64) for k in
        ("B", "V", "Vpad", "k64", "use_global", "row_bytes")]


def pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def row_scratch(rows: int, row_bytes: int, dev):
    """(use_global, row_bytes, scratch tensor or None) of a row kernel whose
    rows need `row_bytes` each: shared memory up to ROW_SMEM, else a global
    scratch row each (16-byte aligned)."""
    if row_bytes <= ROW_SMEM:
        return 0, row_bytes, None
    row_bytes = -(-row_bytes // 16) * 16
    return 1, row_bytes, torch.empty(rows * row_bytes, dtype=torch.uint8,
                                     device=dev)


def top2_votes(keys, valid):
    """keys: (B, V) int32 diagonals, or int64 (pos64); valid: (B, V)
    bool.  Insertion order is the column index (callers lay votes out
    seed-major, SA-hit-minor).  One launch of top2_votes_kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if keys.device.type == "cpu":
        return top2_votes_plain(keys, valid)
    if keys.dtype not in (torch.int32, torch.int64):
        keys = keys.to(torch.int32)
    B, V = keys.shape
    if valid.shape != keys.shape or valid.device != keys.device:
        raise ValueError(f"keys {tuple(keys.shape)} on {keys.device}, valid "
                         f"{tuple(valid.shape)} on {valid.device}")
    if V >= (1 << (_ORD_BITS - 4)):
        raise ValueError(f"top2_votes takes rows of < 2^23 votes, not {V}")
    k64 = keys.dtype == torch.int64
    keys = keys.contiguous()
    valid = valid.to(torch.uint8).contiguous()
    v1 = torch.empty(B, dtype=torch.int32, device=keys.device)
    key1 = torch.empty(B, dtype=keys.dtype, device=keys.device)
    v2 = torch.empty(B, dtype=torch.int32, device=keys.device)
    if B == 0:
        return v1, key1, v2
    Vpad = pow2_at_least(V)
    use_global, row_bytes, scratch = row_scratch(B, 12 * Vpad, keys.device)
    args = Top2Args(keys.data_ptr(), valid.data_ptr(), v1.data_ptr(),
                    key1.data_ptr(), v2.data_ptr(),
                    scratch.data_ptr() if scratch is not None else None,
                    B, V, Vpad, int(k64), use_global, row_bytes)
    lib = native_build.load("vote", VOTE_FUNCS)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.lrm_top2_votes(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"top2_votes kernel launch failed: error {err}")
    top2_votes.launches += 1
    return v1, key1, v2


top2_votes.launches = 0


def top2_votes_plain(keys, valid):
    """Plain version of top2_votes: the stable sort and the run analysis
    in PyTorch ops."""
    if keys.device.type == "cuda":
        top2_votes_plain.cuda_calls += 1
    wide = keys.dtype == torch.int64
    if not wide:
        keys = keys.to(torch.int32)
    B, V = keys.shape
    assert V < (1 << (_ORD_BITS - 4))
    dev = keys.device
    pos = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    if wide:
        payload = (pos << 4) | (keys & 15).to(torch.int32)
        sent = _SENT64
        bucket = torch.where(valid, keys >> 4, sent)
    else:
        payload = (pos << 4) | (keys & 15)
        sent = _SENT
        # bucket + 128 keeps seed-offset-negative keys ordered
        bucket = torch.where(valid, (keys >> 4) + 128, sent)
    b_s, order = torch.sort(bucket, dim=1, stable=True)
    p_s = payload.gather(1, order)
    valid_s = b_s != sent
    pos_s = p_s >> 4
    head = torch.ones_like(valid_s)
    head[:, 1:] = b_s[:, 1:] != b_s[:, :-1]

    # segmented suffix-min of key & 15 within runs (pointer doubling over
    # sorted runs: bucket equality at distance s means one run)
    x = p_s & 15
    s = 1
    while s < V:
        same = torch.zeros_like(valid_s)
        same[:, :-s] = b_s[:, s:] == b_s[:, :-s]
        xs = torch.full_like(x, 15)
        xs[:, :-s] = x[:, s:]
        x = torch.minimum(x, torch.where(same, xs, 15))
        s *= 2
    # valid at run heads
    min_key = b_s * 16 + x if wide else (b_s - 128) * 16 + x

    idx = torch.arange(V, dtype=torch.int32, device=dev)[None, :].expand(
        B, V)
    # next head strictly after v: reverse cummin of head positions
    hp = torch.where(head, idx, V)
    nh = torch.cummin(hp.flip(1), dim=1).values.flip(1)
    nh_after = torch.full_like(nh, V)
    nh_after[:, :-1] = nh[:, 1:]
    count = nh_after - idx                         # run length at heads

    eligible = head & valid_s
    top1, v1 = _top1(count, pos_s, eligible)
    key1 = torch.where(v1 > 0, min_key.gather(1, top1[:, None])[:, 0], 0)
    eligible2 = eligible & (idx != top1[:, None])
    _, v2 = _top1(count, pos_s, eligible2)
    return v1, key1, v2


top2_votes_plain.cuda_calls = 0


def top2_small_histo(keys, valid):
    """Top-2 for the small cross-phase histogram: same semantics,
    O(P^2) dense (P is ~21); int64 keys (pos64) compare directly."""
    if keys.dtype != torch.int64:
        keys = keys.to(torch.int32)
    B, P = keys.shape
    bucket = keys >> 4
    eq = ((bucket[:, :, None] == bucket[:, None, :])
          & valid[:, :, None] & valid[:, None, :])
    counts = eq.sum(dim=2, dtype=torch.int32)
    pidx = torch.arange(P, dtype=torch.int32, device=keys.device)
    earlier = eq & (pidx[None, None, :] < pidx[None, :, None])
    is_first = valid & ~earlier.any(dim=2)
    min_key = torch.where(eq, keys[:, None, :],
                          torch.iinfo(keys.dtype).max).amin(dim=2)
    fo = pidx[None, :].expand(B, P)
    top1, v1 = _top1(counts, fo, is_first)
    key1 = torch.where(v1 > 0, min_key.gather(1, top1[:, None])[:, 0], 0)
    eligible2 = is_first & (pidx[None, :] != top1[:, None])
    _, v2 = _top1(counts, fo, eligible2)
    return v1, key1, v2
