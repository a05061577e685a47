"""Frame-domain sequence parallelism: the coupling flow and HiFi-GAN over
the mesh's ``seq`` axis.

Port of ``sonata_tpu/models/seq_parallel.py``.  The text encoder rides the
seq axis by ring attention (:func:`.modules.transformer_seq_parallel`);
this module carries the same axis through the *frame* domain, so one long
utterance's latent ``z`` and its waveform are split over frames.

Every frame-domain op has a bounded receptive field, so the schedule is
pure halo exchange (:func:`..parallel.ring.halo_exchange`: each shard
takes its neighbours' boundary columns, zeros at the true sequence ends,
which is the zero padding an unsharded conv sees):

- WaveNet convs (kernel 5, dilation 1): halo 2;
- HiFi-GAN resblock dilated convs (kernel ≤ 11, dilation ≤ 5): halo ≤ 25
  samples at that stage's rate, per conv;
- transposed upsampling convs (stride r, kernel k, padding (k−r)/2):
  extend the input by ``h = ceil((k−1−pad)/r)`` frames per side, run the
  same transposed conv and trim ``h·r`` output samples per side — the
  global result, locally.

The model math is :func:`.vits.flow_reverse` and :func:`.vits.decode_with`
with these conv primitives injected; each seq position runs it on its
shard in lockstep with the others (:meth:`..parallel.mesh.Mesh.spmd`), so
the WaveNet gate kernel runs inside ``wn_nct`` at each shard's
``[B/data, 2H, F/seq]``.  Numerics match the unsharded functions
(``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.mesh import SEQ_AXIS, map_rows
from ..parallel.ring import halo_exchange, split_time
from . import modules as m
from .config import VitsHyperParams


def _conv_halo(x, p, *, dilation: int = 1):
    """SAME-padding conv over a sequence-sharded ``[B, C, T]`` via halo
    exchange."""
    k = p.weight.shape[-1]
    k_eff = (k - 1) * dilation + 1
    pl, pr = k_eff // 2, k_eff - 1 - k_eff // 2
    if pl == 0 and pr == 0:  # kernel 1: pointwise, no halo
        return m.conv_nct(x, p)
    ext = halo_exchange(x, pl, pr)
    return F.conv1d(ext, p.weight, p.bias, dilation=dilation)


def _tconv_halo(x, p, *, stride: int, padding: int):
    """Transposed conv over a sharded frame axis: extend the input by ``h``
    frames per side, apply the same transposed conv, and trim ``h*stride``
    output samples per side."""
    k = p.weight.shape[-1]
    a = k - 1 - padding
    h = max(math.ceil(a / stride), 0)
    ext = halo_exchange(x, h, h)
    y = m.conv_transpose_nct(ext, p, stride=stride, padding=padding)
    trim = h * stride
    return y[..., trim: y.shape[-1] - trim] if trim else y


def min_local_frames(hp: VitsHyperParams) -> int:
    """Smallest per-shard frame count for which every halo fits inside the
    immediate neighbour's shard at its stage's sample rate.

    ``halo_exchange`` is neighbour-only, so each stage needs ``local_len
    >= halo``; sample-rate halos (resblock dilated convs, transposed-conv
    extensions) divide back by the cumulative upsample product to frame
    units."""
    need = (7 - 1) // 2 + 1  # conv_pre/conv_post kernel 7 at frame rate
    need = max(need, (hp.flow_kernel_size - 1) // 2 + 1)  # WN convs
    prod = 1
    res_halo = max((k * d - d) // 2 + 1
                   for k, dils in zip(hp.resblock_kernel_sizes,
                                      hp.resblock_dilation_sizes)
                   for d in dils)
    for r, k in zip(hp.upsample_rates, hp.upsample_kernel_sizes):
        pad = (k - r) // 2
        h = max(math.ceil((k - 1 - pad) / r), 0) + 1
        need = max(need, math.ceil(h / prod))  # tconv input halo
        prod *= r
        need = max(need, math.ceil(res_halo / prod))
    return need


def _frames_sharded(fn, p):
    """A :func:`..parallel.mesh.map_rows` body: ``fn(params on the
    device, z shard, *frame shards, g)`` per seq position of the group,
    ``z`` [B, F, ...] and the other frame arguments cut along frames,
    ``g`` whole on every position; the shards' outputs join along dim 1."""
    def group(sub, z, g, *frame_args):
        devs = sub.axis_devices(SEQ_AXIS)
        cuts = [split_time(a, devs, 1) for a in (z,) + frame_args]
        args = [(sub.put(p, d), *(c[j] for c in cuts),
                 None if g is None else g.to(d, non_blocking=True))
                for j, d in enumerate(devs)]
        outs = sub.spmd(SEQ_AXIS, fn, args)
        return torch.cat([o.to(z.device) for o in outs], dim=1)

    return group


def flow_reverse_sp(pf, hp: VitsHyperParams, z, mask, mesh, g=None):
    """Sequence-parallel :func:`.vits.flow_reverse`: ``z`` [B, F, C] and
    ``mask`` [B, F, 1] split over the mesh's seq axis along frames."""
    from . import vits

    def local(pp, zz, mm, gg):
        return vits.flow_reverse(pp, hp, zz, mm, g=gg, conv=_conv_halo)

    return map_rows(mesh, _frames_sharded(local, pf), z, g, mask)


def decode_sp(p, hp: VitsHyperParams, z, mesh, g=None, compute_dtype=None):
    """Sequence-parallel :func:`.vits.decode`: frames split over the seq
    axis; returns the waveform [B, F*hop], joined from the shards' sample
    ranges.  ``compute_dtype`` follows the unsharded path's policy (the
    halo exchanges ride the narrower dtype too)."""
    from . import vits

    def local(pd, zz, gg):
        return vits.decode_with({"dec": pd}, hp, zz, g=gg, conv=_conv_halo,
                                tconv=_tconv_halo,
                                compute_dtype=compute_dtype)

    # decode touches only the generator subtree
    return map_rows(mesh, _frames_sharded(local, p["dec"]), z, g)
