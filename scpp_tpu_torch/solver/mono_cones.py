"""Jordan-algebra / NT-scaling ops of the monolithic IPM, as plain torch
(counterpart of ``scpp_tpu/solver/mono_cones.py``).

Cone tensors stay in the flat ``(..., mc)`` layout [nonneg (l) | SOC q_1
| ... | SOC q_S]; per-cone quantities are slot-broadcast (stored at every
slot of their cone) and ``seg`` is the same-cone sum, one matmul against
a 0/1 indicator. This is the plain version that the CUDA kernel
(csrc/mono_ipm.cu) holds itself against; the kernel computes the same
per-cone quantities once per cone instead of once per slot.
"""

from __future__ import annotations

import torch

__all__ = ["MonoCones"]


class MonoCones:
    """Static cone layout shared by every stage of every scenario."""

    def __init__(self, l: int, soc_sizes, dtype=torch.float32,
                 device="cpu"):
        self.l = int(l)
        self.soc_sizes = tuple(int(q) for q in soc_sizes)
        self.mc = self.l + sum(self.soc_sizes)
        self.S = len(self.soc_sizes)
        offs, off = [], self.l
        for q in self.soc_sizes:
            offs.append(off)
            off += q
        self.soc_offs = tuple(offs)
        self.deg_per_stage = self.l + self.S

        mc = self.mc
        f = dict(dtype=dtype, device=device)
        i = torch.arange(mc, device=device)
        self.lin = (i < self.l).to(dtype)
        self.soc = 1.0 - self.lin
        head = torch.zeros(mc, **f)
        cid = torch.zeros(mc, dtype=torch.long, device=device)
        for o in self.soc_offs:
            head[o] = 1.0
            cid += (i >= o).long()
        self.head = head
        self.tail = self.soc - head
        self.J = self.lin + head - self.tail      # +1 lin/head, -1 tails
        self.e = self.lin + head                  # cone identity element
        self.csum = ((cid[:, None] == cid[None, :]).to(dtype)
                     * self.soc[:, None] * self.soc[None, :])   # (mc, mc)
        self._is_lin = self.lin > 0.5
        self._is_soc = self.soc > 0.5

    # ---- primitives ----

    def seg(self, v):
        """Same-cone sum broadcast over the last axis (soc slots only)."""
        return v @ self.csum

    def hb(self, v):
        """Every slot reads its cone's head value."""
        return self.seg(v * self.head)

    @staticmethod
    def _safe(cond, d):
        """1 where the branch is not taken, so the untaken branch of a
        later ``where`` cannot produce inf/nan."""
        return torch.where(cond, d, torch.ones_like(d))

    # ---- Jordan algebra ----

    def mul(self, u, v):
        s = self.seg(self.soc * u * v)
        t = self.hb(u) * v + self.hb(v) * u
        return self.lin * (u * v) + self.head * s + self.tail * t

    def det(self, u):
        """Per-cone det u0^2 - ||u_tail||^2, slot-broadcast."""
        return self.seg(self.soc * self.J * u * u)

    def inv(self, u):
        d = self._safe(self._is_soc, self.det(u))
        u_lin = self._safe(self._is_lin, u)
        return torch.where(self._is_lin, 1.0 / u_lin, self.J * u / d)

    def min_shift(self, u):
        """(B, K, mc) -> (B, 1) per-scenario interiority defect max."""
        tail_n = torch.sqrt(torch.clamp_min(self.seg(self.tail * u * u), 0.0))
        d_soc = tail_n - self.hb(u)
        val = torch.where(self._is_lin, -u, d_soc)
        return torch.amax(val, dim=(1, 2))[:, None]

    def max_step(self, u, du):
        """(B, K, mc) x2 -> (B, 1) largest step keeping u + a du in the
        cone."""
        big = torch.full((), 1e20, dtype=u.dtype, device=u.device)
        neg1 = -torch.ones_like(du)
        a_lin = torch.where(du < 0, -u / torch.where(du < 0, du, neg1), big)
        a2 = self.seg(self.soc * self.J * du * du)
        b2 = self.seg(self.soc * self.J * u * du)
        c2 = self.det(u)
        disc = b2 ** 2 - a2 * c2
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        root_neg_a = (b2 + sq) / torch.clamp_min(-a2, 1e-30)
        root_pos_a = torch.where((disc > 0) & (b2 < 0),
                                 c2 / torch.clamp_min(-b2 + sq, 1e-30), big)
        lin_r = torch.where(b2 < 0,
                            -c2 / (2.0 * torch.where(b2 < 0, b2, neg1)), big)
        a_soc = torch.where(a2 < -1e-30, root_neg_a,
                            torch.where(a2 > 1e-30, root_pos_a, lin_r))
        u0, du0 = self.hb(u), self.hb(du)
        head_cap = torch.where(du0 < 0, -u0 / torch.where(du0 < 0, du0, neg1),
                               big)
        val = torch.where(self._is_lin, a_lin,
                          torch.minimum(a_soc, head_cap))
        m = torch.amin(val, dim=(1, 2))[:, None]
        return torch.minimum(m, big)

    # ---- NT scaling (slot-broadcast structured rep) ----

    def nt_scaling(self, s, z):
        """Returns (rep, lam); rep = {d, u, detu} all (..., mc)
        slot-broadcast (d meaningful on linear slots, u/detu on SOCs)."""
        soc, head, J = self._is_soc, self.head, self.J
        dets = torch.clamp_min(self.det(s), 1e-30)
        detz = torch.clamp_min(self.det(z), 1e-30)
        sbar = s / torch.sqrt(self._safe(soc, dets))
        zbar = z / torch.sqrt(self._safe(soc, detz))
        szdot = self.seg(self.soc * sbar * zbar)
        gamma = torch.sqrt(torch.clamp_min((1.0 + szdot) / 2.0, 1e-30))
        wbar = (sbar + J * zbar) / (2.0 * gamma)
        eta = (dets / detz) ** 0.25
        wv = eta * wbar
        detw = torch.clamp_min(self.det(wv), 1e-30)
        sqrt_detw = torch.sqrt(detw)
        wv0 = self.hb(wv)
        denom = torch.sqrt(torch.clamp_min(2.0 * (wv0 + sqrt_detw), 1e-30))
        u = (wv + sqrt_detw * head) / self._safe(soc, denom)

        z_lin = self._safe(self._is_lin, z)
        d = torch.sqrt(torch.clamp_min(s * z_lin, 0.0)) / z_lin  # sqrt(s/z)
        rep = {"d": d, "u": u, "detu": sqrt_detw}
        lam_lin = torch.sqrt(torch.clamp_min(s * z, 0.0))
        lam_soc = 2.0 * u * self.seg(self.soc * u * z) - sqrt_detw * (J * z)
        lam = torch.where(self._is_lin, lam_lin, lam_soc)
        return rep, lam

    def identity_rep(self):
        one = torch.ones_like(self.head)
        return {"d": one, "u": self.head, "detu": one}

    def apply_W(self, rep, v):
        w_soc = (2.0 * rep["u"] * self.seg(self.soc * rep["u"] * v)
                 - rep["detu"] * (self.J * v))
        return torch.where(self._is_lin, rep["d"] * v, w_soc)

    def apply_Winv(self, rep, v):
        detu = self._safe(self._is_soc, rep["detu"])
        uinv = self.J * rep["u"] / detu
        w_soc = (2.0 * uinv * self.seg(self.soc * uinv * v)
                 - (self.J * v) / detu)
        d = self._safe(self._is_lin, rep["d"])
        return torch.where(self._is_lin, v / d, w_soc)

    def apply_Winv2(self, rep, v):
        return self.apply_Winv(rep, self.apply_Winv(rep, v))
