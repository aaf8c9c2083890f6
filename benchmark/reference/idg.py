"""Image-domain gridding and degridding, plain and with per-station
A-terms (IDG-AW), written again from the operator.

A record is gridded on the S×S subgrid of its coarse uv tile: with the
padded grid ``HP = N + 2S`` and the fit margin ``M = S/2 − s/2 −
max(6, 12·S/64)`` (s the support), tiles have side ``T = max(2M − 2, 8)``
and the tile ``(ty, tx)`` of a record at padded cell ``(y, x)`` is
``(⌊y⌋/T, ⌊x⌋/T)``; its subgrid's corner is ``ty·T − (S − T)/2`` (held in
the padded grid) and the record sits ``(dy, dx)`` from the subgrid's
centre.  A record with ``|dy|`` or ``|dx|`` above M does not fit and is
dropped and counted; one with no support cell inside the grid is
skipped, not counted.  The subgrid image of the records of one station
pair in one tile is

    a[q, r] = Σ_b v_b · e^{i(2π/S·c_q·dy_b − π(c_q·θ/S)²·w_b)}
                     · e^{i(2π/S·c_r·dx_b − π(c_r·θ/S)²·w_b)},

``c = i − S/2``, times the conjugated pair screen ``conj(A_1·A_2)`` (unit
for plain IDG), transformed by ``F·a·Fᵀ`` (F the centred DFT with the
Kaiser taper folded in) and added at the subgrid's corner.  The image is
the centred inverse FFT of the Hermitian-completed grid divided by the
taper's fine-grid interpolation.  Prediction is the adjoint: the
subgrid window W of the model's spectrum (the model divided by that
divisor first) becomes ``(Fᴴ·W·conj(F)) ∘ (A_1·A_2)`` and each record
reads its conjugated phases.

IDG-AW counts runs as the program's guarantee states them: imaging walks
a time-major raster pair by pair (otherwise the records sorted by pair
and tile), a run is a stretch of one pair in one tile, prediction sorts
by pair and tile, and records of runs past ``8·pairs + n/128 + 64`` are
dropped and counted.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (dft_factor, exact, fft2c, fine_taper, full_f32,
                     grid_size, hermitian, ifft2c, wavelengths,
                     weighted_mirrored)

PAIR_SHIFT = 2**15


def fit_margin(S: int, support: int) -> int:
    return S // 2 - support // 2 - max(6, (12 * S) // 64)


def tiles(p: torch.Tensor, N: int, S: int, support: int):
    """Per record: ``(tile id, corner y, corner x, dy, dx, inside, fits)``
    on the padded grid (``p`` scaled baselines, float32)."""
    M = fit_margin(S, support)
    if M <= 0:
        raise ValueError("subgrid too small for the support and taper")
    HP = N + 2 * S
    T = max(2 * M - 2, 8)
    ycf = (N // 2 + p[:, 1] * N + S).to(torch.float32)
    xcf = (N // 2 + p[:, 0] * N + S).to(torch.float32)
    yc = torch.floor(ycf - S + 0.5).to(torch.int32)
    xc = torch.floor(xcf - S + 0.5).to(torch.int32)
    s = support
    inside = ((yc - s // 2 > -s) & (yc - s // 2 < N)
              & (xc - s // 2 > -s) & (xc - s // 2 < N))
    ty = torch.clamp(ycf, 0, HP - 1).to(torch.int32) // T
    tx = torch.clamp(xcf, 0, HP - 1).to(torch.int32) // T
    ntx = HP // T + 1
    y0 = torch.clamp(ty * T - (S - T) // 2, 0, HP - S)
    x0 = torch.clamp(tx * T - (S - T) // 2, 0, HP - S)
    dy = ycf - (y0.to(torch.float32) + S // 2)
    dx = xcf - (x0.to(torch.float32) + S // 2)
    fits = (torch.abs(dy) <= M) & (torch.abs(dx) <= M)
    return ty * ntx + tx, y0, x0, dy, dx, inside, fits


def _phases(S: int, theta: float, dy, dx, w, rnd):
    """``(e_y, e_x)`` ``[b, S]`` complex64, phases in float32."""
    dev = dy.device
    c = torch.arange(S, dtype=torch.float32, device=dev) - S // 2
    k = torch.tensor(math.pi, dtype=torch.float32, device=dev) \
        * (c * (theta / S)) ** 2
    two_pi_c = torch.tensor(2 * math.pi / S, dtype=torch.float32,
                            device=dev) * c
    ph_y = two_pi_c[None, :] * dy[:, None] - k[None, :] * w[:, None]
    ph_x = two_pi_c[None, :] * dx[:, None] - k[None, :] * w[:, None]
    one = torch.ones_like(ph_y)
    return rnd(torch.polar(one, ph_y)), rnd(torch.polar(one, ph_x))


def screens(akerns, S: int, device) -> torch.Tensor:
    """``[nant, S, S]`` complex64 image-domain screens of the uv-domain
    A-kernels ``[nant, s, s]``: ``Σ_jk E[q, j]·ak[j, k]·E[r, k]`` with
    ``E[q, j] = e^{−2πi(q − S/2)(j − s/2)/S}``, in complex128."""
    ak = torch.as_tensor(np.asarray(akerns), dtype=torch.complex128,
                         device=device)
    s = ak.shape[-1]
    j = torch.arange(s, dtype=torch.float64, device=device) - s // 2
    q = torch.arange(S, dtype=torch.float64, device=device) - S // 2
    ph = -2 * math.pi / S * torch.outer(q, j)
    E = torch.polar(torch.ones_like(ph), ph)
    return (E @ ak @ E.T).to(torch.complex64)


def _run_bound(a1, a2) -> int:
    nant_b = int(max(int(a1.max()), int(a2.max()))) + 2
    npair = torch.unique(a1.long() * nant_b + a2.long()).numel()
    return 8 * npair + a1.numel() // 128 + 64


def _raster_order(req: dict, n: int):
    """The pair-major order of a time-major raster (the same baselines in
    every time slot), or None."""
    t = np.asarray(req["time"])[:n]
    nbl = n if t[0] == t[-1] else int(np.argmax(t != t[0]))
    if nbl == 0 or n % nbl:
        return None
    a1 = np.asarray(req["a1"])[:n].reshape(-1, nbl)
    a2 = np.asarray(req["a2"])[:n].reshape(-1, nbl)
    tr = t.reshape(-1, nbl)
    if not (np.all(a1 == a1[0]) and np.all(a2 == a2[0])
            and np.all(tr == tr[:, :1])):
        return None
    return np.arange(n).reshape(-1, nbl).T.ravel()


def _overflow(run_key, stream_order, placeable, max_runs):
    """Records of runs past ``max_runs``: runs are the stretches of one key
    along ``stream_order`` (None: the distinct keys in sorted order)."""
    if stream_order is None:
        _, run_id = torch.unique(run_key, return_inverse=True)
    else:
        ks = run_key[stream_order]
        new = torch.ones_like(ks, dtype=torch.int64)
        new[1:] = (ks[1:] != ks[:-1]).long()
        run_id = torch.empty_like(new)
        run_id[stream_order] = torch.cumsum(new, 0) - 1
    return placeable & (run_id >= max_runs)


def _geometry(req: dict, cfg: dict, p, aw: bool, imaging: bool):
    """Per record ``(group key, y0, x0, dy, dx, use, dropped)``: which
    records are gridded (``use``) and how many in-grid records are lost."""
    N, S = grid_size(cfg), cfg["subgrid"]
    tkey, y0, x0, dy, dx, inside, fits = tiles(p, N, S, cfg["support"])
    dev = p.device
    if aw:
        a1 = torch.as_tensor(np.asarray(req["a1"]), device=dev).long()
        a2 = torch.as_tensor(np.asarray(req["a2"]), device=dev).long()
        pair = a1 * PAIR_SHIFT + a2
    else:
        pair = torch.zeros_like(tkey, dtype=torch.int64)
    placeable = inside & fits
    dropped = int(torch.sum(inside & ~fits))
    key = pair * (1 << 22) + tkey.long()
    if aw:
        # unplaceable records share one pair key past every station pair
        run_key = torch.where(placeable, key,
                              (1 << 30) * (1 << 22) + tkey.long())
        order = _raster_order(req, p.shape[0]) if imaging else None
        if order is not None:
            order = torch.as_tensor(order, device=dev)
        over = _overflow(run_key, order, placeable, _run_bound(a1, a2))
        dropped += int(torch.sum(over))
        placeable = placeable & ~over
    return key, y0, x0, dy, dx, placeable, dropped


def _groups(key, use):
    """Records in use sorted by group, their group ids and each group's
    first record (into the sorted list)."""
    idx = torch.nonzero(use).squeeze(1)
    uk, inv = torch.unique(key[idx], return_inverse=True)
    order = torch.argsort(inv, stable=True)
    idx, inv = idx[order], inv[order]
    first = torch.searchsorted(inv, torch.arange(uk.numel() + 1,
                                                 device=key.device))
    return idx, inv, first, uk.numel()


def _block(S: int, dev) -> int:
    return max(1, (2**29 if dev.type == "cuda" else 2**25) // (8 * S * S))


def grid(req: dict, cfg: dict, device, rnd=exact, aw: bool = False):
    """``{"image": [N, N] float32, "dropped": int, "region": (lo, hi)}``:
    the image is compared on rows and columns ``lo:hi``."""
    if cfg.get("fov_pad") is not None:
        raise NotImplementedError("the reference images the plain FOV")
    N, S, theta = grid_size(cfg), cfg["subgrid"], cfg["theta"]
    uvw_m, v = weighted_mirrored(req, cfg, device)
    p = uvw_m / cfg["lam"]
    w = uvw_m[:, 2]
    key, y0, x0, dy, dx, use, dropped = _geometry(req, cfg, p, aw, True)
    idx, inv, first, ng = _groups(key, use)
    scr = screens(req["akerns"], S, device) if aw else None
    a1 = torch.as_tensor(np.asarray(req["a1"]), device=device).long()
    a2 = torch.as_tensor(np.asarray(req["a2"]), device=device).long()
    F = rnd(dft_factor(S, cfg["taper_beta"], device))
    FT = F.T.contiguous()
    HP = N + 2 * S
    out = torch.zeros((HP * HP, 2), dtype=torch.float32, device=device)
    ar = torch.arange(S, device=device)
    chunk = 8192 if device.type == "cuda" else 512
    blk = _block(S, device)
    with full_f32():
        for g0 in range(0, ng, blk):
            g1 = min(ng, g0 + blk)
            r0, r1 = int(first[g0]), int(first[g1])
            acc = torch.zeros((g1 - g0, S, S, 2), dtype=torch.float32,
                              device=device)
            for c0 in range(r0, r1, chunk):
                rec = idx[c0:min(r1, c0 + chunk)]
                ey, ex = _phases(S, theta, dy[rec], dx[rec], w[rec], rnd)
                u = rnd(rnd(v[rec])[:, None] * ey)
                acc.index_add_(0, inv[c0:c0 + rec.numel()] - g0,
                               torch.view_as_real(u[:, :, None]
                                                  * ex[:, None, :]))
            head = idx[first[g0:g1]]
            t = rnd(torch.view_as_complex(acc))
            if aw:
                t = t * rnd(torch.conj(scr[a1[head]] * scr[a2[head]]))
                t = rnd(t)
            patch = F @ t @ FT
            rows = y0[head].long()[:, None] + ar
            cols = x0[head].long()[:, None] + ar
            flat = (rows[:, :, None] * HP + cols[:, None, :]).reshape(-1)
            out.index_add_(0, flat, torch.view_as_real(patch).reshape(-1, 2))
    guv = torch.view_as_complex(out).reshape(HP, HP)[S:S + N, S:S + N]
    img = ifft2c(rnd(hermitian(guv))).real
    tf = fine_taper(N, S, cfg["taper_beta"], device).to(torch.float32)
    # the taper division amplifies rounding toward the edges: the image is
    # held to the reference over its central 75%, as the image contract is
    return {"image": img / (tf[:, None] * tf[None, :]), "dropped": dropped,
            "region": (N // 8, N - N // 8)}


def degrid(req: dict, cfg: dict, device, rnd=exact, aw: bool = False):
    """``{"vis": [n] complex64, "dropped": int}``."""
    N, S, theta = grid_size(cfg), cfg["subgrid"], cfg["theta"]
    model = torch.as_tensor(req["model"], dtype=torch.float32,
                            device=device)
    tf = fine_taper(N, S, cfg["taper_beta"], device)
    tf2 = (tf[:, None] * tf[None, :]).to(torch.float32)
    spec = fft2c(rnd((model / tf2).to(torch.complex64)))
    HP = N + 2 * S
    gp = torch.zeros((HP, HP), dtype=torch.complex64, device=device)
    gp[S:S + N, S:S + N] = spec
    uvw_l = wavelengths(req, device)
    p = uvw_l / cfg["lam"]
    w = uvw_l[:, 2]
    key, y0, x0, dy, dx, use, dropped = _geometry(req, cfg, p, aw, False)
    idx, inv, first, ng = _groups(key, use)
    scr = screens(req["akerns"], S, device) if aw else None
    a1 = torch.as_tensor(np.asarray(req["a1"]), device=device).long()
    a2 = torch.as_tensor(np.asarray(req["a2"]), device=device).long()
    F = rnd(dft_factor(S, cfg["taper_beta"], device))
    FH, Fc = F.conj().T.contiguous(), F.conj()
    out = torch.zeros((p.shape[0],), dtype=torch.complex64, device=device)
    ar = torch.arange(S, device=device)
    chunk = (2**25 if device.type == "cuda" else 2**21) // (S * S)
    blk = _block(S, device)
    with full_f32():
        for g0 in range(0, ng, blk):
            g1 = min(ng, g0 + blk)
            r0, r1 = int(first[g0]), int(first[g1])
            head = idx[first[g0:g1]]
            rows = y0[head].long()[:, None] + ar
            cols = x0[head].long()[:, None] + ar
            win = rnd(gp[rows[:, :, None], cols[:, None, :]])
            img = rnd(FH @ win @ Fc)
            if aw:
                img = rnd(img * rnd(scr[a1[head]] * scr[a2[head]]))
            for c0 in range(r0, r1, chunk):
                rec = idx[c0:min(r1, c0 + chunk)]
                ey, ex = _phases(S, theta, dy[rec], dx[rec], w[rec], rnd)
                t = rnd(torch.einsum("bqr,br->bq",
                                     img[inv[c0:c0 + rec.numel()] - g0],
                                     ex.conj()))
                out[rec] = torch.sum(ey.conj() * t, dim=1)
    return {"vis": out, "dropped": dropped}


def image(req, cfg, device, rnd=exact):
    """Plain IDG dirty image (``idg_image``)."""
    return grid(req, cfg, device, rnd)


def predict(req, cfg, device, rnd=exact):
    """Plain IDG prediction (``idg_predict_vis``)."""
    return degrid(req, cfg, device, rnd)


def aw_image(req, cfg, device, rnd=exact):
    """IDG-AW dirty image (``aw_idg_image``)."""
    return grid(req, cfg, device, rnd, aw=True)


def aw_predict(req, cfg, device, rnd=exact):
    """IDG-AW prediction (``aw_predict_vis``)."""
    return degrid(req, cfg, device, rnd, aw=True)


def runs(req: dict, cfg: dict, device, aw: bool, imaging: bool = True):
    """``(records gridded, distinct (pair, tile) groups)`` of these
    inputs: the least counts of subgrid work, for the rooflines."""
    uvw_l = wavelengths(req, device)
    if imaging:
        neg = uvw_l[:, 1] < 0
        uvw_l = torch.where(neg[:, None], -uvw_l, uvw_l)
    p = uvw_l / cfg["lam"]
    key, *_, use, _ = _geometry(req, cfg, p, aw, imaging)
    return int(use.sum()), int(torch.unique(key[use]).numel())
