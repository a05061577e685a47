"""Ring attention: exact attention over a sequence-sharded axis, and the
halo exchange the sharded convolutions use.

Port of ``sonata_tpu/parallel/ring.py``.  Each position of the mesh axis
holds one shard of the sequence; K/V blocks rotate around the ring while
each position accumulates its queries' attention online (flash-attention
style running max and denominator), so the result is *exact* attention
with O(T/n) memory per device.

Inside :meth:`~.mesh.Mesh.spmd` every position is a lane that runs the
same function on its own shard; a collective here (the reference's
``lax.ppermute``) posts the shard a lane sends and takes its neighbour's
with ``shard.to(device, non_blocking=True)`` — a peer copy between two
cards, nothing at all when both positions sit on one device.
"""

from __future__ import annotations

import torch

from .mesh import SEQ_AXIS, Mesh, axis_context


def _permute_next(x, axis_name: str):
    """Every lane sends ``x`` to lane ``j + 1`` (cyclic) and returns what
    lane ``j - 1`` sent."""
    axis, j = axis_context(axis_name)
    board = axis.exchange(j, x)
    return tuple(t.to(x[0].device, non_blocking=True)
                 for t in board[(j - 1) % axis.size])


def _block_attend(q, k, v, mask, m_prev, l_prev, acc_prev, scale,
                  extra_v=None):
    """One K/V block of online-softmax attention.

    q: [B, H, Tq, D]; k/v: [B, H, Tk, D]; mask: [B, 1, Tq, Tk] additive
    (it also carries any extra logits bias, e.g. relative-position terms).
    ``extra_v``: optional [Tq, Tk, D] per-pair value contribution (the
    relative-value table), accumulated with the same weights.  Carries the
    running statistics (m, l, acc)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    if mask is not None:
        logits = logits + mask
    m_cur = torch.amax(logits, dim=-1)  # [B, H, Tq]
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(logits - m_new[..., None])
    l_cur = torch.sum(p, dim=-1)
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + l_cur
    upd = torch.einsum("bhqk,bhkd->bhqd", p, v)
    if extra_v is not None:
        upd = upd + torch.einsum("bhqk,qkd->bhqd", p, extra_v)
    acc_new = acc_prev * alpha[..., None] + upd
    return m_new, l_new, acc_new


def _valid_bias(valid_blk, dtype):
    """[B, Tk] key validity → [B, 1, 1, Tk] additive bias."""
    return torch.where(valid_blk[:, None, None, :] > 0, 0.0,
                       -1e9).to(dtype)


def ring_attention_sharded(q, k, v, kv_valid, *, axis_name: str = SEQ_AXIS):
    """Exact attention where q/k/v are this lane's sequence shard.

    Must run inside :meth:`~.mesh.Mesh.spmd` over ``axis_name``.
    q, k, v: [B, H, T_local, D]; kv_valid: [B, T_local], 1 for real
    positions (the padding mask travels with its K/V shard)."""
    axis, _j = axis_context(axis_name)
    scale = q.shape[-1] ** -0.5
    m = torch.full_like(q[..., 0], -torch.inf)
    l = torch.zeros_like(q[..., 0])
    acc = torch.zeros_like(q)
    k_blk, v_blk = k, v
    valid_blk = kv_valid.to(q.dtype)
    for i in range(axis.size):
        m, l, acc = _block_attend(q, k_blk, v_blk,
                                  _valid_bias(valid_blk, q.dtype), m, l, acc,
                                  scale)
        if i < axis.size - 1:  # the final block needs no rotation
            k_blk, v_blk, valid_blk = _permute_next(
                (k_blk, v_blk, valid_blk), axis_name)
    return acc / torch.clamp(l[..., None], min=1e-9)


def ring_rel_attention_sharded(q, k, v, kv_valid, rel_k, rel_v, *,
                               window: int, axis_name: str = SEQ_AXIS):
    """Ring attention with VITS's learned windowed relative-position
    embeddings (the text encoder's attention,
    :func:`sonata_tpu_torch.models.modules.rel_attention`).

    The relative term touches only positions with ``|s - t| <= window``,
    so on a ring it is nonzero only for the local block and its immediate
    neighbours; it is evaluated per rotating block from that block's
    global offset.

    q, k, v: [B, H, T_local, D]; kv_valid: [B, T_local]; rel_k, rel_v:
    [2*window+1, D] (position ``r`` ⇔ offset ``r - window``).  Must run
    inside :meth:`~.mesh.Mesh.spmd` over ``axis_name``."""
    axis, idx = axis_context(axis_name)
    n = axis.size
    scale = q.shape[-1] ** -0.5
    b, h, t_loc, _d = q.shape
    w = window
    # query · rel-key for all 2w+1 offsets, hoisted out of the ring loop
    qrel = torch.einsum("bhtd,rd->bhtr", q * scale, rel_k)  # [B,H,T,2w+1]
    t_idx = torch.arange(t_loc, device=q.device)

    m = torch.full_like(q[..., 0], -torch.inf)
    l = torch.zeros_like(q[..., 0])
    acc = torch.zeros_like(q)
    k_blk, v_blk = k, v
    valid_blk = kv_valid.to(q.dtype)
    for i in range(n):
        src = (idx - i) % n  # which global block this k/v shard is
        off = (src - idx) * t_loc
        delta = off + (t_idx[None, :] - t_idx[:, None])  # [Tq, Tk]: s - t
        in_win = delta.abs() <= w
        ridx = torch.clamp(delta + w, 0, 2 * w)
        rel_term = torch.gather(
            qrel, -1, ridx.expand(b, h, t_loc, t_loc))
        bias = (torch.where(in_win, rel_term, 0.0)
                + _valid_bias(valid_blk, q.dtype)).to(q.dtype)
        # the relative-value table per (t, s) pair, zero outside the window
        rel_v_g = torch.where(in_win[..., None], rel_v[ridx], 0.0)
        m, l, acc = _block_attend(q, k_blk, v_blk, bias, m, l, acc, scale,
                                  extra_v=rel_v_g)
        if i < n - 1:
            k_blk, v_blk, valid_blk = _permute_next(
                (k_blk, v_blk, valid_blk), axis_name)
    return acc / torch.clamp(l[..., None], min=1e-9)


def halo_exchange(x, pad_left: int, pad_right: int, *,
                  axis_name: str = SEQ_AXIS):
    """Extend this lane's sequence shard ``[..., T_local]`` (time last, as
    in the port's ``[B, C, T]``) with its neighbours' boundary columns:
    zeros at the true sequence ends, which is the zero padding a conv sees
    on the unsharded sequence.  Non-circular: lane 0 gets no left halo
    from lane n-1, lane n-1 no right halo from lane 0."""
    axis, j = axis_context(axis_name)
    n = axis.size
    send = (x[..., -pad_left:] if pad_left else None,
            x[..., :pad_right] if pad_right else None)
    board = axis.exchange(j, send)
    parts = []
    if pad_left:
        parts.append(board[j - 1][0].to(x.device, non_blocking=True)
                     if j > 0 else x.new_zeros(x.shape[:-1] + (pad_left,)))
    parts.append(x)
    if pad_right:
        parts.append(board[j + 1][1].to(x.device, non_blocking=True)
                     if j < n - 1
                     else x.new_zeros(x.shape[:-1] + (pad_right,)))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def split_time(x, devices: list, dim: int) -> list:
    """``x`` cut into ``len(devices)`` equal blocks along ``dim``, block
    ``j`` on ``devices[j]``."""
    n = len(devices)
    size = x.shape[dim] // n
    if size * n != x.shape[dim]:
        raise ValueError(f"length {x.shape[dim]} does not split into {n} "
                         "sequence shards")
    return [x.narrow(dim, j * size, size).to(dev, non_blocking=True)
            for j, dev in enumerate(devices)]


def ring_attention(q, k, v, lengths, mesh: Mesh, *,
                   axis_name: str = SEQ_AXIS):
    """Convenience wrapper: shard [B, H, T, D] q/k/v over the mesh's
    ``axis_name`` axis and run :func:`ring_attention_sharded`.

    ``lengths``: [B] true sequence lengths (positions beyond are masked).
    T must be divisible by the size of the axis.  The ring runs over the
    devices along ``axis_name`` (at index 0 of the other axes); the other
    axes replicate, as the reference's specs do."""
    t = q.shape[2]
    positions = torch.arange(t, device=q.device)[None, :]
    kv_valid = (positions < lengths.to(q.device)[:, None]).to(q.dtype)

    devs = mesh.axis_devices(axis_name)
    args = list(zip(split_time(q, devs, 2), split_time(k, devs, 2),
                    split_time(v, devs, 2), split_time(kv_valid, devs, 1)))
    outs = mesh.spmd(axis_name, lambda *a: ring_attention_sharded(
        *a, axis_name=axis_name), args)
    return torch.cat([o.to(q.device) for o in outs], dim=2)
