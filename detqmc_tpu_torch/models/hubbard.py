"""BSS determinantal QMC for the repulsive Hubbard model — PyTorch port.

Port of detqmc_tpu.models.hubbard (the reference): Hirsch +-1 auxiliary
field, alpha = acosh(e^{dtau U/2}), per-site Metropolis with the
closed-form ratio and Sherman-Morrison rank-1 Green updates, sweeps up and
down with Green wrapping and UdV-stack stabilization every s slices, and
the particle-hole one-sector mode at half filling.

From JAX to PyTorch:
- ``vmap`` over walkers is a leading walker axis written out: every state
  tensor is (W, ...), every spin component rides the next axis (C = 1 in
  particle-hole mode, 2 otherwise).
- ``lax.scan`` is a Python loop; no autograd is involved.
- Randomness comes from an explicit ``torch.Generator`` held by the
  caller, not from a key in the state. The uniforms of a sweep are
  injectable (``u01``), which is how the tests feed JAX's own draws.
- ``HubbardModel`` is an ``nn.Module`` on an explicit device, its
  constants registered buffers.
- Kernel versus plain version is decided by the device of the tensors
  (see linalg/slice_update.py, qr.py, green_solve.py): no config value
  routes the card's main path to a plain version. ``update_kernel`` and
  ``green_kernel`` are validated and otherwise not read; the paths that
  are not ported yet raise NotImplementedError.
- ``stab_dtype`` and ``ozaki_chain_limbs`` are accepted and not read: the
  stack's d/V and the inner solve are always f64 (native on the H100), and
  f64 products are never emulated.

Not ported yet (ROADMAP.md Queue 1 item 7): log_weight, the naive
sweep_simple cross-check, time-displaced Greens, current correlators and
pairing susceptibilities, host_chain_sign.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from detqmc_tpu import lattice as lattice_mod
from detqmc_tpu_torch.linalg import bchain
from detqmc_tpu_torch.linalg.slice_update import (slice_update,
                                                  slice_update_plain)
from detqmc_tpu_torch.linalg.udv import (UDV, green_from_two_udv,
                                         log_det_one_plus_udv, udv_refactor)
from detqmc_tpu_torch.precision import mm

SPIN_SIGN = np.array([+1.0, -1.0])  # component axis: [up, down]
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class HubbardConfig:
    """Static simulation parameters, field for field those of
    detqmc_tpu.models.hubbard.HubbardConfig so configs construct
    identically (see the module docstring for the fields the port does
    not read)."""

    L: int = 4
    d: int = 2
    t: float = 1.0
    U: float = 4.0
    mu: float = 0.0
    beta: float = 4.0
    m: int = 40
    s: int = 8
    checkerboard: bool = False
    cb_apply: str = "auto"
    delay: int = 0
    ph_symmetry: str = "auto"
    update_kernel: str = "auto"
    green_kernel: str = "auto"
    green_refine_iters: int = 1
    ozaki_chain_limbs: int = 5
    dtype: str = "float32"
    stab_dtype: str = "auto"
    stagger_h: float = 0.0

    def __post_init__(self):
        if self.m % self.s != 0:
            raise ValueError(f"m={self.m} must be divisible by s={self.s}")
        if self.d not in (1, 2, 3):
            raise ValueError(f"d must be 1, 2 or 3, got {self.d}")
        if self.checkerboard and self.L % 2 != 0:
            raise ValueError("checkerboard requires even L")
        if self.delay < 0:
            raise ValueError("delay must be >= 0")
        if self.cb_apply not in ("auto", "dense", "sparse"):
            raise ValueError("cb_apply must be auto|dense|sparse, got "
                             f"{self.cb_apply!r}")

    @property
    def dtau(self) -> float:
        return self.beta / self.m

    @property
    def n_sites(self) -> int:
        return self.L ** self.d

    @property
    def n_stack(self) -> int:
        return self.m // self.s

    @property
    def alpha(self) -> float:
        return float(np.arccosh(np.exp(self.dtau * self.U / 2.0)))

    @property
    def ph_on(self) -> bool:
        if self.ph_symmetry == "auto":
            return self.mu == 0.0
        if self.ph_symmetry in ("on", "off"):
            return self.ph_symmetry == "on"
        raise ValueError(f"bad ph_symmetry {self.ph_symmetry!r}")

    @property
    def ncomp(self) -> int:
        return 1 if self.ph_on else 2

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32|float64, got "
                             f"{self.dtype!r}")
        return _DTYPES[self.dtype]


class Stack(NamedTuple):
    """UdV stack: entry k factors B_{ks}..B_1 (left, after an up sweep) or
    (B_m..B_{ks+1})^T (right, after a down sweep / init)."""

    U: torch.Tensor  # (W, K+1, C, N, N) run dtype
    d: torch.Tensor  # (W, K+1, C, N)    f64
    V: torch.Tensor  # (W, K+1, C, N, N) f64


class WalkerState(NamedTuple):
    """Per-walker state, walkers leading (JAX's WalkerState minus ``key``:
    the generator is held by the caller)."""

    field: torch.Tensor        # (W, m, N) +-1 Hirsch spins, run dtype
    G: torch.Tensor            # (W, C, N, N) equal-time G at the sweep edge
    stack: Stack
    sign: torch.Tensor         # (W,) exact weight sign (ratio-tracked)
    next_dir: torch.Tensor     # (W,) int32: 0 = next sweep up, 1 = down
    sweeps_done: torch.Tensor  # (W,) int32
    green_dev: torch.Tensor    # (W,) f32 max |G_wrapped - G_stab| last sweep
    sv_min: torch.Tensor       # (W,) f32 log10 smallest stack scale
    sv_max: torch.Tensor       # (W,) f32
    h: torch.Tensor            # (W,) staggered HS bias (cfg.stagger_h)


class Observables(NamedTuple):
    """Per-walker measurement (sign-weighted, as in the JAX package)."""

    occupancy: torch.Tensor
    doubleOccupancy: torch.Tensor
    kineticEnergy: torch.Tensor
    potentialEnergy: torch.Tensor
    totalEnergy: torch.Tensor
    sign: torch.Tensor
    spinCorrelation: torch.Tensor      # (W, N) translation-averaged
    spinStructureFactorAF: torch.Tensor
    acceptance: torch.Tensor


class HubbardModel(nn.Module):
    """Config + device constants (registered buffers) + the sweep."""

    def __init__(self, cfg: HubbardConfig, device=None):
        super().__init__()
        if cfg.delay > 0:
            raise NotImplementedError(
                "delay > 0 (the delayed rank-k Hubbard update, kernel K1b) "
                "is not ported yet: ROADMAP.md Queue 2, 'Hubbard delayed "
                "update'")
        if cfg.green_kernel == "refine":
            raise NotImplementedError(
                "green_kernel='refine' is not ported yet: ROADMAP.md "
                "Queue 1 item 9 (the refine route with the trinv kernel)")
        if cfg.update_kernel not in ("auto", "scan", "pallas", "lanes"):
            raise ValueError(f"unknown update_kernel {cfg.update_kernel!r}")
        if cfg.green_kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown green_kernel {cfg.green_kernel!r}")
        if cfg.ph_on and cfg.mu != 0.0:
            raise ValueError("ph_symmetry='on' requires mu == 0")
        self.cfg = cfg
        self.lat = (lattice_mod.SquareLattice(cfg.L) if cfg.d == 2 else
                    lattice_mod.HyperCubicLattice(cfg.L, cfg.d))
        dt = cfg.torch_dtype
        self.dtype = dt
        self.ncomp = cfg.ncomp
        self.cb_sparse = cfg.checkerboard and cfg.cb_apply == "sparse"
        prop = bchain.make_propagators(
            self.lat, cfg.t, cfg.dtau, cfg.mu, dtype=dt, device=device,
            checkerboard=cfg.checkerboard,
            cb_dense=cfg.checkerboard and not self.cb_sparse)
        for name, tensor in prop._asdict().items():
            self.register_buffer(name, tensor)
        N = cfg.n_sites
        s_ = np.arange(N)
        c_ = self.lat.coords(s_)

        def buf(name, a, dtype=dt):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(a), dtype=dtype, device=device))

        buf("K_mat", self.lat.hopping_matrix(cfg.t))
        buf("spin_sign", SPIN_SIGN[:self.ncomp])
        # disp_idx[d, i] = site index of r_i + r_d
        buf("disp_idx", self.lat.site_of(c_[None, :, :] + c_[:, None, :]),
            torch.int64)
        buf("stagger", self.lat.stagger())

    @property
    def prop(self) -> bchain.Propagators:
        return bchain.Propagators(self.expK, self.expK_inv, self.cb_partner,
                                  self.cb_cosh, self.cb_sinh, self.cb_gamma)

    @property
    def device(self) -> torch.device:
        return self.expK.device

    def _eye_mixed(self, W: int) -> UDV:
        """Identity UdV per walker and component: U in the run dtype, d/V
        in f64 (the stack layout)."""
        N, C, dev = self.cfg.n_sites, self.ncomp, self.device
        f64 = torch.float64
        return UDV(torch.eye(N, dtype=self.dtype, device=dev).expand(
                       W, C, N, N),
                   torch.ones(W, C, N, dtype=f64, device=dev),
                   torch.eye(N, dtype=f64, device=dev).expand(W, C, N, N))

    # -- potential diagonals ------------------------------------------------
    def exp_v(self, field_slice: torch.Tensor) -> torch.Tensor:
        """e_l = exp(spin * alpha * s_l): (W, C, N) from (W, N)."""
        return torch.exp(self.spin_sign[:, None] * self.cfg.alpha
                         * field_slice[:, None, :])

    # -- site updates --------------------------------------------------------
    def _update_slice(self, G, field_l, u01, sign):
        """The plain chain (K1's plain version) regardless of device."""
        return slice_update_plain(G, field_l, u01, sign, self.cfg.alpha)

    def update_slice(self, G, field_l, u01, sign):
        """K1 on a CUDA tensor, its plain version on a CPU tensor."""
        return slice_update(G.contiguous(), field_l.contiguous(),
                            u01.contiguous(), sign.contiguous(),
                            self.cfg.alpha)

    # -- wraps ----------------------------------------------------------------
    def wrap_up(self, G, e):
        """G(l) = B_l G(l-1) B_l^{-1}."""
        cb = self.cb_sparse
        return bchain.b_mult_left(
            self.prop, e,
            bchain.b_inv_mult_right(self.prop, G, e, checkerboard=cb),
            checkerboard=cb)

    def wrap_down(self, G, e):
        """G(l-1) = B_l^{-1} G(l) B_l."""
        cb = self.cb_sparse
        return bchain.b_inv_mult_left(
            self.prop, e,
            bchain.b_mult_right(self.prop, G, e, checkerboard=cb),
            checkerboard=cb)

    # -- measurements ----------------------------------------------------------
    def measure_equal_time(self, G: torch.Tensor, acc_rate,
                           sign=None) -> Observables:
        """Wick-contracted equal-time estimators from G (W, C, N, N)."""
        cfg = self.cfg
        N = cfg.n_sites
        W = G.shape[0]
        if sign is None:
            sign = torch.ones(W, dtype=G.dtype, device=G.device)
        eye = torch.eye(N, dtype=G.dtype, device=G.device)
        Gu = G[:, 0]
        if cfg.ph_on:
            st_ = self.stagger
            Gd = st_[:, None] * (eye - Gu.mT) * st_[None, :]
        else:
            Gd = G[:, 1]
        nu = 1.0 - torch.diagonal(Gu, dim1=-2, dim2=-1)
        nd = 1.0 - torch.diagonal(Gd, dim1=-2, dim2=-1)
        occ = (nu + nd).mean(-1)
        docc = (nu * nd).mean(-1)
        KT = self.K_mat.T
        e_kin = -((KT * Gu).sum((-2, -1)) + (KT * Gd).sum((-2, -1))) / N
        e_pot = cfg.U * (nu * nd - 0.5 * (nu + nd) + 0.25).mean(-1)
        mz = nu - nd
        corr = 0.25 * (mz[:, :, None] * mz[:, None, :]
                       + (eye - Gu.mT) * Gu + (eye - Gd.mT) * Gd)
        rows = torch.arange(N, device=G.device)[None, :]
        c_of_d = corr[:, rows, self.disp_idx].mean(-1)
        s_af = mm(corr, self.stagger[:, None])[..., 0] @ self.stagger / N
        return Observables(
            occupancy=occ * sign,
            doubleOccupancy=docc * sign,
            kineticEnergy=e_kin * sign,
            potentialEnergy=e_pot * sign,
            totalEnergy=(e_kin + e_pot) * sign,
            sign=sign,
            spinCorrelation=c_of_d * sign[:, None],
            spinStructureFactorAF=s_af * sign,
            acceptance=acc_rate,
        )

    # -- sweeps -----------------------------------------------------------------
    def _sweep(self, state: WalkerState, up: bool, measure: bool,
               u01=None, generator=None):
        """One full pass over all time slices (up: l = 1..m, down:
        l = m..1), consuming the opposite-direction UdV stack and emitting
        this direction's. ``u01`` (W, m, N): the raw uniforms of the sweep;
        None draws them from ``generator``."""
        cfg = self.cfg
        K, s_int, N, dt = cfg.n_stack, cfg.s, cfg.n_sites, self.dtype
        cb = self.cb_sparse
        field = state.field.clone()
        G, stack, sign = state.G, state.stack, state.sign
        W = field.shape[0]
        if u01 is None:
            if generator is None:
                raise ValueError("_sweep needs u01 or a torch.Generator")
            u01 = torch.rand((W, cfg.m, N), generator=generator, dtype=dt,
                             device=self.device)
        # staggered HS bias folded exactly into the uniforms (each site is
        # visited once per slice with its sweep-start field value); at
        # h = 0 the factor is exp(0) = 1 and u01 is unchanged
        u01 = u01 * torch.exp((2.0 * state.h)[:, None, None]
                              * self.stagger[None, None, :] * field)
        u01 = u01.transpose(0, 1).contiguous()        # (m, W, N)

        eye_f = self._eye_mixed(W)
        lazy_U, d_c, V_c = eye_f
        dev = torch.zeros(W, dtype=dt, device=self.device)
        acc_sum = torch.zeros(W, dtype=dt, device=self.device)
        obs_sum = None
        emitted = []
        ks = range(1, K + 1) if up else range(K, 0, -1)
        for k in ks:
            # consumed entry: up uses right entries k, down left entries k-1
            ci = k if up else k - 1
            other = UDV(stack.U[:, ci], stack.d[:, ci], stack.V[:, ci])
            for l_rel in range(s_int):
                l = (k - 1) * s_int + 1 + l_rel if up else k * s_int - l_rel
                fl = field[:, l - 1]
                if up:
                    G = self.wrap_up(G, self.exp_v(fl))
                G, fl_new, sign, acc = self.update_slice(G, fl, u01[l - 1],
                                                         sign)
                field[:, l - 1] = fl_new
                e_new = self.exp_v(fl_new)
                if up:
                    lazy_U = bchain.b_mult_left(self.prop, e_new, lazy_U,
                                                checkerboard=cb)
                else:
                    lazy_U = bchain.bT_mult_left(self.prop, e_new, lazy_U,
                                                 checkerboard=cb)
                    G = self.wrap_down(G, e_new)
                acc_sum = acc_sum + acc
            # re-orthogonalize: run-dtype QR of the lazy block, f64 d/V
            f_new = udv_refactor(lazy_U, d_c, V_c)
            G_stab = (green_from_two_udv(f_new, other) if up
                      else green_from_two_udv(other, f_new))
            dev = torch.maximum(dev, (G - G_stab).abs().amax((-3, -2, -1)))
            G = G_stab
            if measure:
                obs = self.measure_equal_time(G, torch.zeros_like(sign),
                                              sign)
                obs_sum = obs if obs_sum is None else Observables(
                    *[a + b for a, b in zip(obs_sum, obs)])
            lazy_U, d_c, V_c = f_new
            emitted.append(f_new)

        # new stack: up emits positions 1..K, down positions K-1..0
        if not up:
            emitted = emitted[::-1]

        def assemble(leaves, eye_leaf):
            parts = [eye_leaf] + leaves if up else leaves + [eye_leaf]
            return torch.stack(parts, dim=1)

        new_stack = Stack(assemble([f.U for f in emitted], eye_f.U),
                          assemble([f.d for f in emitted], eye_f.d),
                          assemble([f.V for f in emitted], eye_f.V))
        logd = torch.log10(torch.clamp(
            torch.stack([f.d for f in emitted], dim=1), min=1e-38))
        new_state = WalkerState(
            field=field, G=G, stack=new_stack, sign=sign,
            next_dir=torch.full_like(state.next_dir, 1 if up else 0),
            sweeps_done=state.sweeps_done + 1,
            green_dev=dev.float(),
            sv_min=logd.amin((1, 2, 3)).float(),
            sv_max=logd.amax((1, 2, 3)).float(),
            h=state.h)
        if obs_sum is None:
            zero = self.measure_equal_time(G, torch.zeros_like(sign), sign)
            obs_sum = Observables(*[torch.zeros_like(a) for a in zero])
        obs_mean = Observables(*[a / K for a in obs_sum])
        # acceptance is a whole-sweep average (per-slice rates over m)
        obs_mean = obs_mean._replace(acceptance=acc_sum / cfg.m)
        return new_state, obs_mean

    def sweep_up(self, state, measure=False, u01=None, generator=None):
        return self._sweep(state, True, measure, u01, generator)

    def sweep_down(self, state, measure=False, u01=None, generator=None):
        return self._sweep(state, False, measure, u01, generator)

    def sweep_pair(self, state: WalkerState, measure: bool, u01=None,
                   generator=None):
        """Up + down = 2 reference sweeps; measurements averaged. ``u01``:
        None, or the (up, down) pair of (W, m, N) uniforms."""
        u_up, u_dn = (None, None) if u01 is None else u01
        state, obs1 = self._sweep(state, True, measure, u_up, generator)
        state, obs2 = self._sweep(state, False, measure, u_dn, generator)
        return state, Observables(*[0.5 * (a + b)
                                    for a, b in zip(obs1, obs2)])

    # -- setup -------------------------------------------------------------------
    def init_state(self, n_walkers: int,
                   generator: torch.Generator) -> WalkerState:
        """Random Hirsch fields; the right stack and stabilized G(0) built
        from scratch."""
        cfg = self.cfg
        N, K, C, W, dev = cfg.n_sites, cfg.n_stack, self.ncomp, n_walkers, \
            self.device
        dt, f64, i32 = self.dtype, torch.float64, torch.int32
        bits = torch.randint(0, 2, (W, cfg.m, N), generator=generator,
                             device=dev)
        field = (2.0 * bits - 1.0).to(dt)
        state0 = WalkerState(
            field=field,
            G=torch.zeros(W, C, N, N, dtype=dt, device=dev),
            stack=Stack(torch.zeros(W, K + 1, C, N, N, dtype=dt, device=dev),
                        torch.zeros(W, K + 1, C, N, dtype=f64, device=dev),
                        torch.zeros(W, K + 1, C, N, N, dtype=f64,
                                    device=dev)),
            sign=torch.ones(W, dtype=dt, device=dev),
            next_dir=torch.zeros(W, dtype=i32, device=dev),
            sweeps_done=torch.zeros(W, dtype=i32, device=dev),
            green_dev=torch.zeros(W, dtype=torch.float32, device=dev),
            sv_min=torch.zeros(W, dtype=torch.float32, device=dev),
            sv_max=torch.zeros(W, dtype=torch.float32, device=dev),
            h=torch.full((W,), cfg.stagger_h, dtype=dt, device=dev))
        return self.refresh_from_field(state0)

    def refresh_from_field(self, state: WalkerState) -> WalkerState:
        """Recompute the right stack and G(0) from the field alone."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        field = state.field
        W = field.shape[0]
        eye_f = self._eye_mixed(W)
        f = eye_f
        emitted = []
        for k in range(K, 0, -1):
            # absorb (B_{ks} .. B_{(k-1)s+1})^T in descending order
            lazy_U = f.U
            for l_rel in range(s_int):
                l = k * s_int - l_rel
                lazy_U = bchain.bT_mult_left(
                    self.prop, self.exp_v(field[:, l - 1]), lazy_U,
                    checkerboard=self.cb_sparse)
            f = udv_refactor(lazy_U, f.d, f.V)
            emitted.append(f)
        # emitted positions K-1 .. 0: reverse, identity at K
        emitted = emitted[::-1]
        stack = Stack(*[torch.stack([getattr(e, leaf) for e in emitted]
                                    + [getattr(eye_f, leaf)], dim=1)
                        for leaf in ("U", "d", "V")])
        full_t = UDV(stack.U[:, 0], stack.d[:, 0], stack.V[:, 0])
        G = green_from_two_udv(eye_f, full_t)
        sign = self._chain_sign(full_t).to(self.dtype)
        return state._replace(G=G, stack=stack, sign=sign,
                              next_dir=torch.zeros_like(state.next_dir))

    def _chain_sign(self, full_t: UDV) -> torch.Tensor:
        """sign(prod_sigma det(1 + B-chain)) from the factored chain (W,),
        via f64 slogdet (native on the card). At half filling in
        particle-hole mode det M_up det M_dn = e^{-alpha sum s}
        (det M_up)^2 > 0."""
        W = full_t.U.shape[0]
        if self.cfg.ph_on:
            return torch.ones(W, dtype=torch.float64, device=self.device)
        _, sgns = log_det_one_plus_udv(full_t)
        return sgns.prod(-1)
