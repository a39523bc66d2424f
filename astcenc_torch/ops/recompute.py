"""Least-squares endpoint refit for fixed weights, 1 or 2 planes.

Port of ``astcenc_tpu/ops/recompute.py::recompute_ideal_colors_1plane``
(:14-149; reference astcenc_ideal_endpoints_and_weights.cpp:1146-1368)
and ``recompute_ideal_colors_2planes`` (:150): per partition, the 2x2
normal equations of each channel and of the RGB-scale line, as masked
reductions over the texel axis; for the HDR profiles also the RGBO vector
of FMT_HDR_RGB_SCALE (a structured 4x4 solve, :282).

The texel sums run in the order of the kernels' warp reduction
(``lane_sum``), so the plain versions and kernels K2/K3 fit bit-identical
endpoints; a last-bit difference there can flip an endpoint quantization
and move a trial error by percents.
"""

from __future__ import annotations

import torch

from .. import obs
from . import softfloat as sf


def lane_sum(x, dim: int):
    """Sum over ``dim`` in the order of a 32-lane warp reduction: element t
    goes to lane t % 32, each lane adds its elements in order, then the
    lanes combine by an xor butterfly (csrc/common.cuh::warp_sum)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    pad = (-n) % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.reshape(x.shape[:-1] + (-1, 32))
    v = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        v = v + x[..., i, :]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _weights(channel_weight, dev):
    """(cw, ls_weight): a static tuple as a (4,) tensor and its R + G + B
    as a float, or per-block (N, 4) weights and their (N,) R + G + B, each
    summed in double and rounded once as the kernels sum it
    (csrc/refine_common.cuh::rgb_weight)."""
    if torch.is_tensor(channel_weight):
        cw = channel_weight
        d = cw.to(torch.float64)
        return cw, ((d[:, 0] + d[:, 1]) + d[:, 2]).to(torch.float32)
    wait = obs.on and obs.sync("recompute.channel_weight", "h2d")
    cw = torch.tensor(channel_weight, dtype=torch.float32, device=dev)
    if wait:
        obs.end(wait, cw.nbytes)
    return cw, float(channel_weight[0] + channel_weight[1]
                     + channel_weight[2])


def _psum(pmask, x):
    """Per-partition texel sum: (N, T, P), (N, T[, C]) -> (N, P[, C])."""
    if x.dim() == 2:
        return lane_sum(pmask * x[..., None], 1)
    return lane_sum(pmask[..., None] * x[:, :, None, :], 1)


def recompute_ideal_colors_1plane(texels, pmask, counts, undec_weights,
                                  channel_weight, ep0_in, ep1_in,
                                  is_hdr: bool = False):
    """Refit endpoints per partition given per-texel weights.

    Args:
      texels: (N, T, 4); pmask: (N, T, P) one-hot; counts: (N, P).
      undec_weights: (N, T) infilled weights in [0, 1].
      channel_weight: static 4-tuple, or per-block (N, 4) weights.
      ep0_in/ep1_in: (N, P, 4) previous endpoints, kept where a solve fails.
      is_hdr: also compute the RGBO vector of FMT_HDR_RGB_SCALE.

    Returns dict: ep0, ep1, rgbs (N, P, 4), and rgbo (N, P, 4) if is_hdr.
    """
    cw, ls_weight = _weights(channel_weight, texels.device)
    if cw.dim() == 2:
        cw = cw[:, None, :]                                   # (N, 1, 4)
        ls_weight = ls_weight[:, None]                        # (N, 1)
    idx = undec_weights
    om = 1.0 - idx

    rgba_sum = _psum(pmask, texels) * cw
    tc = counts.to(torch.float32)
    rgba_weight_sum = torch.clamp(cw * tc[..., None], min=1e-17)
    mean_rgb = (rgba_sum / rgba_weight_sum)[..., :3]
    norm = sf.sqrt(sf.sum3(mean_rgb * mean_rgb))[..., None]
    scale_dir = mean_rgb / torch.where(norm > 0, norm, 1.0)
    scale_dir_t = torch.einsum("ntp,npc->ntc", pmask, scale_dir)
    scale = sf.sum3(scale_dir_t * texels[..., :3])

    big = 1e10
    inpart = pmask.transpose(1, 2) > 0
    scale_min = torch.where(inpart, scale[:, None, :], big).amin(2)
    scale_max = torch.where(inpart, scale[:, None, :], -big).amax(2)
    wmin = torch.where(inpart, idx[:, None, :], 1.0).amin(2)
    wmax = torch.where(inpart, idx[:, None, :], 0.0).amax(2)

    left_s = _psum(pmask, om * om)
    middle_s = _psum(pmask, om * idx)
    right_s = _psum(pmask, idx * idx)
    cvy = _psum(pmask, texels * idx[..., None]) * cw
    cvx = _psum(pmask, texels * om[..., None]) * cw
    sv0 = _psum(pmask, om * scale) * ls_weight
    sv1 = _psum(pmask, idx * scale) * ls_weight

    left = left_s[..., None] * cw
    middle = middle_s[..., None] * cw
    right = right_s[..., None] * cw
    lm0 = left_s * ls_weight
    lm1 = middle_s * ls_weight
    lm2 = right_s * ls_weight

    scalediv = torch.clamp(scale_min / torch.clamp(scale_max, min=1e-10),
                           0.0, 1.0)
    sds = scale_dir * scale_max[..., None]
    rgbs = torch.cat([sds, scalediv[..., None]], -1)
    all_same = wmin >= wmax * 0.999

    avg = (cvx + cvy) / rgba_weight_sum
    notnan = ~torch.isnan(avg)
    ep0_same = torch.where(notnan, avg, ep0_in)
    ep1_same = torch.where(notnan, avg, ep1_in)
    rgbs_same = torch.cat([sds, torch.ones_like(scalediv[..., None])], -1)

    det = left * right - middle * middle
    rdet = 1.0 / det
    mss = left * left + 2.0 * middle * middle + right * right
    ep0_f = (right * cvx - middle * cvy) * rdet
    ep1_f = (left * cvy - middle * cvx) * rdet
    full = ((det.abs() > mss * 1e-4)
            & ~(torch.isnan(ep0_f) | torch.isnan(ep1_f)))
    ep0_fit = torch.where(full, ep0_f, ep0_in)
    ep1_fit = torch.where(full, ep1_f, ep1_in)

    ls_det = lm0 * lm2 - lm1 * lm1
    ls_rdet = 1.0 / ls_det
    ls_mss = lm0 * lm0 + 2.0 * lm1 * lm1 + lm2 * lm2
    se0 = (lm2 * sv0 - lm1 * sv1) * ls_rdet
    se1 = (lm0 * sv1 - lm1 * sv0) * ls_rdet
    ls_ok = ((ls_det.abs() > ls_mss * 1e-4) & ~torch.isnan(se0)
             & ~torch.isnan(se1) & (se0 < se1))
    rgbs_fit = torch.cat(
        [scale_dir * se1[..., None],
         (se0 / torch.where(se1 != 0, se1, 1.0))[..., None]], -1)
    rgbs_out = torch.where(ls_ok[..., None], rgbs_fit, rgbs)

    as_ = all_same[..., None]
    out = {"ep0": torch.where(as_, ep0_same, ep0_fit),
           "ep1": torch.where(as_, ep1_same, ep1_fit),
           "rgbs": torch.where(as_, rgbs_same, rgbs_out)}
    if is_hdr:
        out["rgbo"] = _rgbo(rgba_weight_sum, (_psum(pmask, idx) + 1e-17)[
            ..., None] * cw, cvx, cvy, right_s * ls_weight, out["ep0"],
            out["ep1"])
    return out


def _rgbo(rgba_ws, wws, cvx, cvy, psum, ep0, ep1):
    """The RGBO vector of FMT_HDR_RGB_SCALE (reference :1099-1143, JAX
    recompute.py:133-145, :263-277): the structured 4x4 solve, or where
    it gives NaN the endpoints' midpoint and mean RGB difference."""
    rgbq = torch.cat([(cvx + cvy)[..., :3], sf.sum3(cvy)[..., None]], -1)
    rgbo = _compute_rgbo(rgba_ws, wws, rgbq, psum)
    bad = torch.isnan((rgbo * rgbo).sum(-1))
    avgdif = torch.clamp(sf.div(sf.sum3(ep1 - ep0), 3.0), min=0.0)
    ep0b = (ep0 + ep1) * 0.5 - avgdif[..., None] * 0.5
    fallback = torch.cat([ep0b[..., :3], avgdif[..., None]], -1)
    return torch.where(bad[..., None], fallback, rgbo)


def _compute_rgbo(rgba_ws, wws, rgbq_sum, psum):
    """Structured 4x4 inverse of the HDR RGBO solve (reference
    :1099-1143)."""
    X, Y, Z = rgba_ws[..., 0], rgba_ws[..., 1], rgba_ws[..., 2]
    P, Q, R = wws[..., 0], wws[..., 1], wws[..., 2]
    S = psum
    PP, QQ, RR = P * P, Q * Q, R * R
    SZmRR = S * Z - RR
    DT = SZmRR * Y - Z * QQ
    YP = Y * P
    QX = Q * X
    YX = Y * X
    mZYP = -Z * YP
    mZQX = -Z * QX
    mRYX = -R * YX
    ZQP = Z * Q * P
    RYP = R * YP
    RQX = R * QX
    rdet = 1.0 / (DT * X + mZYP * P)
    mats = (
        (DT, ZQP, RYP, mZYP),
        (ZQP, SZmRR * X - Z * PP, RQX, mZQX),
        (RYP, RQX, (S * Y - QQ) * X - Y * PP, mRYX),
        (mZYP, mZQX, mRYX, Z * YX))
    vect = rgbq_sum * rdet[..., None]
    return torch.stack([
        ((m[0] * vect[..., 0] + m[1] * vect[..., 1]) + m[2] * vect[..., 2])
        + m[3] * vect[..., 3] for m in mats], -1)


def recompute_ideal_colors_2planes(texels, undec_w1, undec_w2, p2c,
                                   channel_weight, data_mean, ep0_in, ep1_in,
                                   is_hdr: bool = False):
    """Refit single-partition endpoints for two weight planes (port of
    ``recompute_ideal_colors_2planes``, astcenc_tpu/ops/recompute.py:150;
    reference :1369-1650). Texel sums run in kernel K3's order.

    Args:
      texels: (N, T, 4); undec_w1/undec_w2: (N, T) infilled weights.
      p2c: (N,) plane-2 component; data_mean: (N, 4) block mean.
      channel_weight: static 4-tuple, or per-block (N, 4) weights.
      ep0_in/ep1_in: (N, 4) previous endpoints, kept where a solve fails.
      is_hdr: also compute the RGBO vector of FMT_HDR_RGB_SCALE.

    Returns dict: ep0, ep1, rgbs (N, 4), and rgbo (N, 4) if is_hdr.
    """
    dev = texels.device
    cw, ls_weight = _weights(channel_weight, dev)
    N, T, _ = texels.shape
    p2_mask = torch.arange(4, device=dev)[None, :] == p2c[:, None]

    rgba_weight_sum = torch.clamp(cw * T, min=1e-17)
    mean_rgb = data_mean[..., :3]
    norm = sf.sqrt(sf.sum3(mean_rgb * mean_rgb))[:, None]
    scale_dir = mean_rgb / torch.where(norm > 0, norm, 1.0)
    scale = sf.sum3(scale_dir[:, None, :] * texels[..., :3])      # (N, T)
    scale_min = scale.amin(1)
    scale_max = scale.amax(1)

    def lmr(idx):
        om = 1.0 - idx
        return (lane_sum(om * om, 1), lane_sum(om * idx, 1),
                lane_sum(idx * idx, 1), idx.amin(1), idx.amax(1))

    l1, m1, r1, wmin1, wmax1 = lmr(undec_w1)
    l2, m2, r2, wmin2, wmax2 = lmr(undec_w2)
    color_idx = torch.where(p2_mask[:, None, :], undec_w2[..., None],
                            undec_w1[..., None])                 # (N, T, 4)
    cvy = lane_sum(texels * color_idx, 1) * cw
    cvx = lane_sum(texels * (1.0 - color_idx), 1) * cw
    sv0 = lane_sum((1.0 - undec_w1) * scale, 1) * ls_weight
    sv1 = lane_sum(undec_w1 * scale, 1) * ls_weight

    scalediv = torch.clamp(scale_min / torch.clamp(scale_max, min=1e-10),
                           0.0, 1.0)
    sds = scale_dir * scale_max[:, None]
    avg = (cvx + cvy) / rgba_weight_sum
    notnan = ~torch.isnan(avg)

    def solve(lsum, msum, rsum):
        left = lsum[:, None] * cw
        middle = msum[:, None] * cw
        right = rsum[:, None] * cw
        det = left * right - middle * middle
        rdet = 1.0 / det
        mss = left * left + 2.0 * middle * middle + right * right
        e0 = (right * cvx - middle * cvy) * rdet
        e1 = (left * cvy - middle * cvx) * rdet
        ok = (det.abs() > mss * 1e-4) & ~torch.isnan(e0) & ~torch.isnan(e1)
        return e0, e1, ok

    ep0, ep1 = ep0_in, ep1_in
    allsame1 = (wmin1 >= wmax1 * 0.999)[:, None]
    e0f, e1f, okf = solve(l1, m1, r1)
    take_same = allsame1 & ~p2_mask & notnan
    take_fit = ~allsame1 & ~p2_mask & okf
    ep0 = torch.where(take_same, avg, torch.where(take_fit, e0f, ep0))
    ep1 = torch.where(take_same, avg, torch.where(take_fit, e1f, ep1))

    lm0, lm1, lm2 = l1 * ls_weight, m1 * ls_weight, r1 * ls_weight
    ls_det = lm0 * lm2 - lm1 * lm1
    ls_mss = lm0 * lm0 + 2.0 * lm1 * lm1 + lm2 * lm2
    se0 = (lm2 * sv0 - lm1 * sv1) / ls_det
    se1 = (lm0 * sv1 - lm1 * sv0) / ls_det
    ls_ok = ((ls_det.abs() > ls_mss * 1e-4) & ~torch.isnan(se0)
             & ~torch.isnan(se1) & (se0 < se1))
    rgbs_fit = torch.cat(
        [scale_dir * se1[:, None],
         (se0 / torch.where(se1 != 0, se1, 1.0))[:, None]], -1)
    rgbs = torch.cat([sds, scalediv[:, None]], -1)
    rgbs = torch.where(allsame1, torch.cat([sds, torch.ones_like(sds[:, :1])],
                                           -1),
                       torch.where(ls_ok[:, None], rgbs_fit, rgbs))

    allsame2 = (wmin2 >= wmax2 * 0.999)[:, None]
    e0f2, e1f2, okf2 = solve(l2, m2, r2)
    take_same2 = allsame2 & p2_mask & notnan
    take_fit2 = ~allsame2 & p2_mask & okf2
    ep0 = torch.where(take_same2, avg, torch.where(take_fit2, e0f2, ep0))
    ep1 = torch.where(take_same2, avg, torch.where(take_fit2, e1f2, ep1))
    out = {"ep0": ep0, "ep1": ep1, "rgbs": rgbs}
    if is_hdr:
        www = lane_sum(color_idx, 1) + 1e-17
        rsel = torch.where(p2_mask, r2[:, None], r1[:, None]) * cw
        out["rgbo"] = _rgbo(rgba_weight_sum.expand(N, 4), www * cw, cvx, cvy,
                            sf.sum3(rsel), ep0, ep1)
    return out
