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
  routes the card's main path to a plain version. The site update follows
  ``HubbardModel.routes``: the delayed rank-k update (K1b) when ``delay >
  0`` or ``update_kernel="pallas"``, as the JAX model routes it, and on
  the card also when G does not fit K1's shared memory (N > 128); the
  rank-1 update (K1) otherwise. ``green_kernel`` "auto", "xla",
  "pallas" and "refine" all mean the inner solve K3 (K8 + K9 beyond one
  block); "refine" keeps the JAX model's rule (float32 with the f64
  stabilization island, else ValueError), and ``green_refine_iters`` is
  accepted and not read. The JAX refine route (a float32 QR, R^{-1} and
  Newton-Schulz steps) was slower than the inner solve on the card at
  equal or worse green_dev (PERF.md; ROADMAP.md Queue 3, Divergences).
- ``stab_dtype`` and ``ozaki_chain_limbs`` are accepted and not read: the
  whole UdV stack (U, d and V), the lazy block products that feed its
  refactor QR, the inner matrix and its solve are always f64 (native on
  the H100; f64 products are never emulated). The run dtype is G's, the
  field's and the G wraps' and updates'. The JAX package keeps the
  stack's U and the lazy blocks in the run dtype; in float32 that costs
  the stabilized G eps_f32 cond(B-block) of accuracy, which at L=16,
  beta=8, s=4 keeps the wrap deviation above the 6e-3 gate (PERF.md;
  ``python -m detqmc_tpu_torch.stabilization_check``).

Unequal-time measurements (``timedisplaced``, ``timedisplacedSlices`` and
``currentCorrelators`` of detqmc_tpu/driver.py): ``_td_stacks`` builds
both half-chain stacks from the field, ``time_displaced_greens`` solves
G(tau, 0) at the K+1 anchors with the dense-RHS inner solve
(udv.green_tau_zero: K3's ``_rhs`` entry on the card, on every
``green_kernel``; the JAX model's df32 / refine choices of that solve are
not ported),
the ``_all`` variants wrap between anchors to every slice, and
``measure_time_displaced``, ``pair_susceptibilities`` and
``measure_current_correlators`` reduce them. Walkers lead, then the
anchor (or slice) axis, then the spin component.

The parallel-tempering hooks (JAX hubbard.py:704-769): the tempered
parameter is the staggered HS bias h (``control_parameter =
"stagger_h"``; ``with_r`` keeps the JAX name), ``exchange_action`` its
conjugate -sum eta s, and ``log_weight`` the whole configuration's
log|w| from entry 0 of the transposed stack, the one refresh_from_field
builds (``log_weight_and_stack`` returns that stack too, so det-coupled PT
refreshes a walker from it).

The naive cross-check (JAX hubbard.py:770-830): ``green_at_slice``
rebuilds G(l) from the field with a refactor at every slice, and
``sweep_simple`` runs the sweep's site updates on such a G at every slice
with the same uniforms as ``sweep_up`` (the staggered bias folded in as
``_sweep`` folds it), so both walk the same chain.

Not ported: host_chain_sign (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from detqmc_tpu_torch import lattice as lattice_mod
from detqmc_tpu_torch.linalg import _kernels, bchain
from detqmc_tpu_torch.linalg import slice_update as su
from detqmc_tpu_torch.linalg.udv import (UDV, green_from_two_udv,
                                         green_tau_zero,
                                         log_det_one_plus_udv, udv_refactor)
from detqmc_tpu_torch.models.unequal_time import (trapezoid_weights,
                                                  wrap_between_anchors)
from detqmc_tpu_torch.precision import mm

SPIN_SIGN = np.array([+1.0, -1.0])  # component axis: [up, down]
CHAIN_DTYPE = torch.float64         # the UdV stack and its block products
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

    U: torch.Tensor  # (W, K+1, C, N, N) f64 (CHAIN_DTYPE)
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
    """Config + device constants (registered buffers) + the sweep.

    ``vector_observables`` declares which observable names are vectors
    (the driver registers them with its observable handler)."""

    vector_observables = ("spinCorrelation", "greenKTauVector",
                          "currentCorrelatorVector")

    def __init__(self, cfg: HubbardConfig, device=None):
        super().__init__()
        if cfg.green_kernel == "refine":
            # the JAX model's rule (hubbard.py:323-330): float32 with the
            # f64 stabilization island
            stab = (("float64" if cfg.dtype == "float32" else cfg.dtype)
                    if cfg.stab_dtype == "auto" else cfg.stab_dtype)
            if cfg.dtype != "float32" or stab == cfg.dtype:
                raise ValueError("green_kernel='refine' needs dtype="
                                 "float32 with the f64 stab island")
        if cfg.update_kernel not in ("auto", "scan", "pallas", "lanes"):
            raise ValueError(f"unknown update_kernel {cfg.update_kernel!r}")
        if cfg.update_kernel == "lanes" and cfg.delay > 0:
            raise ValueError("update_kernel='lanes' has no delayed path "
                             "(use 'pallas' or 'scan')")
        if cfg.green_kernel not in ("auto", "xla", "pallas", "refine"):
            raise ValueError(f"unknown green_kernel {cfg.green_kernel!r}")
        if cfg.ph_on and cfg.mu != 0.0:
            raise ValueError("ph_symmetry='on' requires mu == 0")
        # the card unless the caller names another device: on a machine
        # without one, torch's own error, never a silent CPU run
        device = torch.device("cuda" if device is None else device)
        self.route = self.routes(cfg, device.type)
        k = self.route["chunk"]
        if (self.route["update"] == "slice_update_delayed"
                and device.type == "cuda" and not su.delayed_fits(
                    cfg.ncomp, cfg.n_sites, k, cfg.torch_dtype)):
            need = su.delayed_smem_bytes(cfg.ncomp, cfg.n_sites, k,
                                         cfg.torch_dtype)
            raise ValueError(
                f"delay={k}: K1b's buffers for N={cfg.n_sites}, "
                f"C={cfg.ncomp}, {cfg.dtype} need {need} bytes of shared "
                f"memory, beyond the {_kernels.MAX_SMEM_BYTES - 1024} a "
                "block may use")
        self.cfg = cfg
        self.lat = (lattice_mod.SquareLattice(cfg.L) if cfg.d == 2 else
                    lattice_mod.HyperCubicLattice(cfg.L, cfg.d))
        dt = cfg.torch_dtype
        self.dtype = dt
        self.ncomp = cfg.ncomp
        self.cb_sparse = cfg.checkerboard and cfg.cb_apply == "sparse"
        # the run dtype's propagators for G; f64 ones for the stack
        for dtype, suffix in ((dt, ""), (CHAIN_DTYPE, "_chain")):
            prop = bchain.make_propagators(
                self.lat, cfg.t, cfg.dtau, cfg.mu, dtype=dtype,
                device=device, checkerboard=cfg.checkerboard,
                cb_dense=cfg.checkerboard and not self.cb_sparse)
            for name, tensor in prop._asdict().items():
                self.register_buffer(name + suffix, tensor)
        N = cfg.n_sites
        s_ = np.arange(N)
        c_ = self.lat.coords(s_)

        def buf(name, a, dtype=dt):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(a), dtype=dtype, device=device))

        buf("K_mat", self.lat.hopping_matrix(cfg.t))
        buf("spin_sign", SPIN_SIGN[:self.ncomp])
        buf("spin_sign_chain", SPIN_SIGN[:self.ncomp], CHAIN_DTYPE)
        # disp_idx[d, i] = site index of r_i + r_d
        buf("disp_idx", self.lat.site_of(c_[None, :, :] + c_[:, None, :]),
            torch.int64)
        buf("stagger", self.lat.stagger())
        # cos / sin of the Fourier phases exp(-i k.r): G(k, tau) and the
        # current correlator's Lambda(q) as real matmuls
        kg = self.lat.k_grid()
        buf("four_cos", np.cos(kg @ c_.T))
        buf("four_sin", np.sin(kg @ c_.T))
        if cfg.d == 2:
            # the d-wave pair form factor and the smallest longitudinal /
            # transverse momenta of the superfluid stiffness
            buf("_dwave_D", self.lat.dwave_form_factor())
            q1 = 2.0 * np.pi / cfg.L
            self.q_long_idx = int(np.argmin(
                np.abs(kg - np.asarray([q1, 0.0])).sum(axis=1)))
            self.q_trans_idx = int(np.argmin(
                np.abs(kg - np.asarray([0.0, q1])).sum(axis=1)))
        else:
            self.register_buffer("_dwave_D", None)

    @staticmethod
    def routes(cfg: HubbardConfig, device_type: str) -> dict:
        """{"update": "slice_update" (K1, rank-1) | "slice_update_delayed"
        (K1b), "chunk": k} for a model on a device of this type: the
        delayed update when delay > 0 or update_kernel="pallas" (the JAX
        model's routes, hubbard.py:471-488), and on a CUDA device also
        where no plan of K1 fits G (slice_update.plan). The chunk is cfg.delay, or
        without one the largest divisor of N up to 32 (the Pallas kernel's
        choice) that fits K1b's shared memory; the rank-1 update's chunk
        is 1."""
        N, C = cfg.n_sites, cfg.ncomp
        k1_fits = su.fits(C, N, cfg.torch_dtype)
        delayed = (cfg.delay > 0 or cfg.update_kernel == "pallas"
                   or (device_type == "cuda" and not k1_fits))
        if not delayed:
            return {"update": "slice_update", "chunk": 1}
        return {"update": "slice_update_delayed",
                "chunk": cfg.delay if cfg.delay > 0
                else su.default_chunk(C, N, cfg.torch_dtype)}

    @property
    def prop(self) -> bchain.Propagators:
        """The propagators in the run dtype (G's wraps)."""
        return bchain.Propagators(self.expK, self.expK_inv, self.cb_partner,
                                  self.cb_cosh, self.cb_sinh, self.cb_gamma)

    @property
    def prop_chain(self) -> bchain.Propagators:
        """The propagators in f64 (the stack's block products)."""
        return bchain.Propagators(
            self.expK_chain, self.expK_inv_chain, self.cb_partner_chain,
            self.cb_cosh_chain, self.cb_sinh_chain, self.cb_gamma_chain)

    @property
    def device(self) -> torch.device:
        return self.expK.device

    def _eye_mixed(self, W: int) -> UDV:
        """Identity UdV per walker and component: U in CHAIN_DTYPE, d and
        V in f64 (the stack layout)."""
        N, C, dev = self.cfg.n_sites, self.ncomp, self.device
        f64 = torch.float64
        return UDV(torch.eye(N, dtype=CHAIN_DTYPE, device=dev).expand(
                       W, C, N, N),
                   torch.ones(W, C, N, dtype=f64, device=dev),
                   torch.eye(N, dtype=f64, device=dev).expand(W, C, N, N))

    # -- potential diagonals ------------------------------------------------
    def exp_v(self, field_slice: torch.Tensor) -> torch.Tensor:
        """e_l = exp(spin * alpha * s_l): (..., C, N) from (..., N), e.g.
        (W, C, N) from one slice (W, N), (W, m, C, N) from the field."""
        return torch.exp(self.spin_sign[:, None] * self.cfg.alpha
                         * field_slice[..., None, :])

    def exp_v_chain(self, field_slice: torch.Tensor) -> torch.Tensor:
        """``exp_v`` in f64, for the stack's block products."""
        return torch.exp(self.spin_sign_chain[:, None] * self.cfg.alpha
                         * field_slice[..., None, :].to(CHAIN_DTYPE))

    # -- site updates --------------------------------------------------------
    def _update_slice(self, G, field_l, u01, sign):
        """The route's plain chain (K1's or K1b's plain version) regardless
        of device."""
        if self.route["update"] == "slice_update":
            return su.slice_update_plain(G, field_l, u01, sign,
                                         self.cfg.alpha)
        return su.slice_update_delayed_plain(G, field_l, u01, sign,
                                             self.cfg.alpha,
                                             self.route["chunk"])

    def update_slice(self, G, field_l, u01, sign):
        """The route's kernel (K1 or K1b) on a CUDA tensor, its plain
        version on a CPU tensor."""
        args = [x.contiguous() for x in (G, field_l, u01, sign)]
        if self.route["update"] == "slice_update":
            return su.slice_update(*args, self.cfg.alpha)
        return su.slice_update_delayed(*args, self.cfg.alpha,
                                       self.route["chunk"])

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
                e_chain = self.exp_v_chain(fl_new)
                if up:
                    lazy_U = bchain.b_mult_left(self.prop_chain, e_chain,
                                                lazy_U, checkerboard=cb)
                else:
                    lazy_U = bchain.bT_mult_left(self.prop_chain, e_chain,
                                                 lazy_U, checkerboard=cb)
                    G = self.wrap_down(G, self.exp_v(fl_new))
                acc_sum = acc_sum + acc
            # re-orthogonalize: f64 QR of the lazy block, f64 d/V
            f_new = udv_refactor(lazy_U, d_c, V_c)
            G_stab = (green_from_two_udv(f_new, other) if up
                      else green_from_two_udv(other, f_new)).to(dt)
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

    # -- naive cross-check sweep ---------------------------------------------
    def green_at_slice(self, field: torch.Tensor, l: int) -> torch.Tensor:
        """Stabilized G(l) (W, C, N, N) rebuilt from the field alone with a
        refactor at every slice: the naive recompute behind sweep_simple
        (the JAX model's green_at_slice; the stack's f64 block products).
        ``l`` in 0..m."""
        cb = self.cb_sparse
        left = right = self._eye_mixed(field.shape[0])
        for j in range(1, l + 1):
            left = udv_refactor(bchain.b_mult_left(
                self.prop_chain, self.exp_v_chain(field[:, j - 1]), left.U,
                checkerboard=cb), left.d, left.V)
        for j in range(self.cfg.m, l, -1):
            right = udv_refactor(bchain.bT_mult_left(
                self.prop_chain, self.exp_v_chain(field[:, j - 1]), right.U,
                checkerboard=cb), right.d, right.V)
        return green_from_two_udv(left, right).to(self.dtype)

    def sweep_simple(self, state: WalkerState, measure: bool = False,
                     u01=None, generator=None):
        """Naive up sweep (the JAX model's sweep_simple): G(l) from
        ``green_at_slice`` at every slice, then the same site updates as
        ``sweep_up`` on the same uniforms (``u01`` (W, m, N) or drawn from
        ``generator``), so both walk the same chain and a disagreement
        indicts the wraps and the stack. The staggered bias is folded into
        the uniforms as ``_sweep`` folds it (the JAX sweep_simple leaves it
        out, so it leaves sweep_up's chain at stagger_h != 0). Measures
        after the update of every s-th slice; the state is refreshed from
        the field and keeps the tracked sign. O(m^2) refactors: a
        cross-check, not a production path."""
        cfg = self.cfg
        field, sign = state.field.clone(), state.sign
        W = field.shape[0]
        if u01 is None:
            if generator is None:
                raise ValueError("sweep_simple needs u01 or a "
                                 "torch.Generator")
            u01 = torch.rand((W, cfg.m, cfg.n_sites), generator=generator,
                             dtype=self.dtype, device=self.device)
        u01 = u01 * torch.exp((2.0 * state.h)[:, None, None]
                              * self.stagger[None, None, :] * field)
        acc_sum = torch.zeros(W, dtype=self.dtype, device=self.device)
        obs_sum = None
        for l in range(1, cfg.m + 1):
            G = self.green_at_slice(field, l)       # fresh, pre-update
            G, fl_new, sign, acc = self.update_slice(
                G, field[:, l - 1], u01[:, l - 1], sign)
            field[:, l - 1] = fl_new
            acc_sum = acc_sum + acc
            if measure and l % cfg.s == 0:
                obs = self.measure_equal_time(G, torch.zeros_like(sign),
                                              sign)
                obs_sum = obs if obs_sum is None else Observables(
                    *[a + b for a, b in zip(obs_sum, obs)])
        new_state = self.refresh_from_field(state._replace(field=field))
        new_state = new_state._replace(sign=sign,
                                       sweeps_done=state.sweeps_done + 1)
        if obs_sum is None:
            zero = self.measure_equal_time(new_state.G, acc_sum, sign)
            obs_sum = Observables(*[torch.zeros_like(a) for a in zero])
        obs_mean = Observables(*[a / cfg.n_stack for a in obs_sum])
        return new_state, obs_mean._replace(acceptance=acc_sum / cfg.m)

    # -- parallel tempering hooks ------------------------------------------------
    # h is linear in the bosonic action, so label swaps need no determinant
    # (the same protocol as SDW's r); h = 0 samples the physical model
    control_parameter = "stagger_h"

    def exchange_action(self, state: WalkerState) -> torch.Tensor:
        """The h-conjugate action piece a = -sum_{l,i} eta_i s_{l,i} per
        walker (W,): the weight carries e^{-h a}."""
        return -torch.sum(self.stagger * state.field, dim=(1, 2))

    def with_r(self, state: WalkerState, h) -> WalkerState:
        """Set every walker's h ((W,) or a scalar); G and the stack stay
        valid, h never enters the determinant. The name is SDW's: the PT
        driver is parameter-agnostic."""
        return state._replace(h=torch.as_tensor(
            h, dtype=self.dtype, device=self.device).expand_as(
                state.h).contiguous())

    def log_weight(self, field: torch.Tensor, h=None) -> torch.Tensor:
        """log|w(s)| of each walker's configuration (W,), float64, up to an
        s-independent constant: sum_sigma log|det(1 + B_sigma-chain)| +
        h sum eta s; in particle-hole mode 2 log|det M_up| - alpha sum s
        (det M_up det M_dn = e^{-alpha sum s} det M_up^2). ``h``: None
        (cfg.stagger_h), a number or (W,). Det-coupled parallel tempering
        swaps configurations on it."""
        return self.log_weight_and_stack(field, h)[0]

    def log_weight_and_stack(self, field: torch.Tensor, h=None):
        """(log_weight, the transposed stack it was read from): the stack
        refresh_from_field builds for this field."""
        cfg = self.cfg
        stack = self._build_stack(field, transposed=True)
        lds, _ = log_det_one_plus_udv(
            UDV(stack.U[:, 0], stack.d[:, 0], stack.V[:, 0]))
        s = field.to(torch.float64)
        if cfg.ph_on:
            ld = 2.0 * lds[:, 0] - cfg.alpha * s.sum(dim=(1, 2))
        else:
            ld = lds.sum(-1)
        h = cfg.stagger_h if h is None else torch.as_tensor(h).to(
            device=field.device, dtype=torch.float64)
        stag = torch.sum(self.stagger.to(torch.float64) * s, dim=(1, 2))
        return ld + h * stag, stack

    # -- unequal-time measurements ----------------------------------------------
    def _td_stacks(self, field: torch.Tensor):
        """Both half-chain stacks, built fresh from the field: left entries
        k hold B(ks, 0), right entries k hold B(beta, ks)^T (W, K+1, C,
        ...)."""
        return (self._build_stack(field, transposed=False),
                self._build_stack(field, transposed=True))

    @staticmethod
    def _both_orders(left: UDV, right_t: UDV):
        """The stacks (left | right_t, right_t | left) on a new leading
        axis: one batched green_tau_zero solves both orders."""
        return (UDV(*[torch.stack([a, b]) for a, b in zip(left, right_t)]),
                UDV(*[torch.stack([b, a]) for a, b in zip(left, right_t)]))

    def _gtz_both(self, left: UDV, right_t: UDV):
        """(gtz(left, right_t), gtz(right_t, left)) in one batched
        dense-RHS solve: G(tau, 0) and the swapped-roles solve (G(beta,
        tau)^T for a real field), each (W, K+1, C, N, N)."""
        G = green_tau_zero(*self._both_orders(left, right_t)).to(self.dtype)
        return G[0], G[1]

    def time_displaced_greens(self, field: torch.Tensor) -> torch.Tensor:
        """G(tau = k s dtau, 0) for k = 0..K: (W, K+1, 2, N, N).

        Both half-chain stacks are built fresh from the field and all K+1
        anchors come from one batched stable solve. In particle-hole mode
        the down sector is the exact per-configuration image G_dn(tau, 0)
        = eta G_up(beta, tau)^T eta (eta = stagger; eta B_dn,l eta =
        B_up,l^{-T} at mu = 0), and G_up(beta, tau)^T is the solve with
        the two stacks' roles swapped."""
        left, right_t = self._td_stacks(field)
        if not self.cfg.ph_on:
            return green_tau_zero(left, right_t).to(self.dtype)
        G_up, G_bt = self._gtz_both(left, right_t)
        eta = self.stagger
        return torch.cat([G_up, eta[:, None] * G_bt * eta[None, :]], dim=2)

    def _slice_factors(self, field: torch.Tensor) -> torch.Tensor:
        """exp(spin alpha s) of every slice, (W, K, s, 2, N) (interval,
        offset): in particle-hole mode the down sector's 1/e (B_dn =
        e^{-alpha s} expK at mu = 0)."""
        cfg = self.cfg
        e = self.exp_v(field)                             # (W, m, C, N)
        if cfg.ph_on:
            e = torch.cat([e, 1.0 / e], dim=2)
        return e.reshape(field.shape[0], cfg.n_stack, cfg.s, *e.shape[2:])

    def time_displaced_greens_all(self, field: torch.Tensor):
        """G(tau, 0) at every slice tau = 0..m: (W, m+1, 2, N, N), and the
        wrap deviation (W,) against the stabilized anchors. Within
        interval k, G(ks+j+1, 0) = B_{ks+j+1} G(ks+j, 0)."""
        anchors = self.time_displaced_greens(field)
        e = self._slice_factors(field)
        cb = self.cb_sparse

        def step(j, chains):
            return [bchain.b_mult_left(self.prop, e[:, :, j], chains[0],
                                       checkerboard=cb)]

        (G_all,), dev = wrap_between_anchors([anchors], self.cfg.s, step)
        return G_all, dev

    def unequal_time_greens_all(self, field: torch.Tensor):
        """G(tau, 0), G(0, tau) and G(tau, tau) at every slice, both spin
        sectors: three (W, m+1, 2, N, N) tensors and the wrap deviation
        (W,) over all three.

        With A = B(tau, 0) (left stack) and C = B(beta, tau) (right),
        gtz(right_t, left) = [(1 + C A)^{-1} C]^H, so G(0, tau) =
        -(1 + C A)^{-1} C = -gtz(right_t, left)^T for the real field; the
        G(tau, tau) anchors are the equal-time pair formula (K3). The
        chains wrap between anchors as G(tau+1, 0) = B G(tau, 0),
        G(0, tau+1) = G(0, tau) B^{-1}, G(tau+1, tau+1) = B G B^{-1}. In
        particle-hole mode the down sector is reconstructed exactly:
        G_dn(tau, 0) = eta G_up(beta, tau)^T eta, G_dn(0, tau) = -eta
        G_up(tau, 0)^T eta, G_dn(tau, tau) = eta (1 - G_up(tau, tau))^T
        eta."""
        cfg = self.cfg
        cb = self.cb_sparse
        left, right_t = self._td_stacks(field)
        G_fwd, G_bwd = self._gtz_both(left, right_t)
        Gtt = green_from_two_udv(left, right_t).to(self.dtype)
        T = lambda M: M.transpose(-1, -2)                 # noqa: E731
        if cfg.ph_on:
            eta = self.stagger
            sgn = eta[:, None] * eta[None, :]
            eye = torch.eye(cfg.n_sites, dtype=Gtt.dtype, device=Gtt.device)
            t0 = torch.cat([G_fwd, sgn * G_bwd], dim=2)
            zt = torch.cat([-T(G_bwd), -sgn * T(G_fwd)], dim=2)
            tt = torch.cat([Gtt, sgn * (eye - T(Gtt))], dim=2)
        else:
            t0, zt, tt = G_fwd, -T(G_bwd), Gtt
        del G_fwd, G_bwd, Gtt
        e = self._slice_factors(field)

        def step(j, chains):
            a, b, c = chains
            ej = e[:, :, j]
            a = bchain.b_mult_left(self.prop, ej, a, checkerboard=cb)
            b = bchain.b_inv_mult_right(self.prop, b, ej, checkerboard=cb)
            c = bchain.b_inv_mult_right(
                self.prop, bchain.b_mult_left(self.prop, ej, c,
                                              checkerboard=cb),
                ej, checkerboard=cb)
            return [a, b, c]

        (t0, zt, tt), dev = wrap_between_anchors([t0, zt, tt], cfg.s, step)
        return t0, zt, tt, dev

    def measure_current_correlators(self, state: WalkerState):
        """tau-integrated current-current correlator Lambda_xx(q, iw=0)
        over the full q grid (W, N), the superfluid-stiffness estimator
        rho_s = [Lambda_L - Lambda_T] / 4 (W,) from the smallest
        longitudinal and transverse momenta (Scalapino-White-Zhang), and
        the wrap deviation (W,). Wick at fixed field with all three
        unequal-time chains; with X = G(0, tau)^T, Y = G(tau, 0), P the +x
        shift and u(tau)_i = sum_sigma [G(tau,tau)_{i,i+x} -
        G(tau,tau)_{i+x,i}] the bond current,

            <j_x(i,tau) j_x(j,0)> = -t^2 [ u(tau)_i u(0)_j
                - sum_sigma ((PX)(YP^T) - (PXP^T)Y - X(PYP^T)
                             + (XP^T)(PY))_ij ].

        2-D lattices only."""
        cfg = self.cfg
        if cfg.d != 2:
            raise ValueError("current correlators are implemented for "
                             "d = 2 lattices")
        t0, zt, tt, dev = self.unequal_time_greens_all(state.field)
        N = cfg.n_sites
        px = torch.as_tensor(self.lat.neighbors()[:, 0], device=t0.device)
        ar = torch.arange(N, device=t0.device)
        u_tau = (tt[..., ar, px] - tt[..., px, ar]).sum(dim=2)  # (W, m+1, N)
        del tt
        X, Y = zt.transpose(-1, -2), t0
        PX, XP = X.index_select(-2, px), X.index_select(-1, px)
        PY, YP = Y.index_select(-2, px), Y.index_select(-1, px)
        PXP, PYP = PX.index_select(-1, px), PY.index_select(-1, px)
        conn = (PX * YP - PXP * Y - X * PYP + XP * PY).sum(dim=2)
        w = trapezoid_weights(cfg.m, cfg.dtau, conn.dtype, conn.device)
        lam = -(cfg.t ** 2) * (
            torch.einsum("t,wti,wj->wij", w, u_tau, u_tau[:, 0])
            - torch.einsum("t,wtij->wij", w, conn))
        Fc, Fs = self.four_cos, self.four_sin
        lam_q = (torch.einsum("qi,wij,qj->wq", Fc, lam, Fc)
                 + torch.einsum("qi,wij,qj->wq", Fs, lam, Fs)) / N
        rho_s = 0.25 * (lam_q[:, self.q_long_idx]
                        - lam_q[:, self.q_trans_idx])
        return lam_q, rho_s, dev

    def measure_time_displaced(self, state: WalkerState,
                               per_slice: bool = False,
                               susceptibilities: bool = False):
        """Momentum-diagonal G(k, tau), averaged over both spin sectors:
        (W, K+1, N) on the stabilization grid or, with ``per_slice``,
        (W, m+1, N) at every slice, returned with the wrap deviation (W,).
        ``susceptibilities`` (needs ``per_slice``) also returns the
        tau-integrated s- and d-wave pairing susceptibilities (W,) each,
        from the same per-slice G(tau, 0)."""
        if susceptibilities and not per_slice:
            raise ValueError("susceptibilities need per_slice=True "
                             "(trapezoid over every tau slice)")
        if per_slice:
            G_tau, dev = self.time_displaced_greens_all(state.field)
        else:
            G_tau = self.time_displaced_greens(state.field)
        # Re (F G F^H)_kk with F = exp(-i k.r) = cos - i sin
        Fc, Fs = self.four_cos, self.four_sin
        gk = (torch.einsum("ki,wtcij,kj->wtk", Fc, G_tau, Fc)
              + torch.einsum("ki,wtcij,kj->wtk", Fs, G_tau, Fs))
        gk = gk / (G_tau.shape[2] * self.cfg.n_sites)
        if susceptibilities:
            return (gk, dev) + self.pair_susceptibilities(G_tau)
        return (gk, dev) if per_slice else gk

    def pair_susceptibilities(self, G_tau: torch.Tensor):
        """tau-integrated s- and d_{x2-y2}-wave pairing susceptibilities
        (W,) each, from per-slice G(tau, 0) (W, m+1, 2, N, N), by Wick at
        fixed field:

            P = (1/N) sum_ij int_0^beta dtau G_up(tau,0)_ij
                                             [D G_dn(tau,0) D^T]_ij

        with D the identity (on-site s-wave) or the signed nearest-
        neighbor form factor (d-wave, 2-D only; 0 elsewhere); the tau
        integral is the trapezoid over all m+1 slices."""
        cfg = self.cfg
        up, dn = G_tau[:, :, 0], G_tau[:, :, -1]
        w = trapezoid_weights(cfg.m, cfg.dtau, up.dtype, up.device)
        ps = torch.einsum("t,wtij,wtij->w", w, up, dn) / cfg.n_sites
        if self._dwave_D is None:
            return ps, torch.zeros_like(ps)
        D = self._dwave_D
        pd = torch.einsum("t,wtij,wtij->w", w, up,
                          mm(mm(D, dn), D.T)) / cfg.n_sites
        return ps, pd

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
            stack=Stack(torch.zeros(W, K + 1, C, N, N, dtype=f64, device=dev),
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

    def _build_stack(self, field: torch.Tensor, transposed: bool) -> UDV:
        """A UdV stack from the field, (W, K+1, C, ...): straight (left)
        entries k hold B_{ks} .. B_1 (identity at 0); transposed (right)
        entries k hold (B_m .. B_{ks+1})^T (identity at K, the whole chain
        at 0)."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        cb = self.cb_sparse
        eye_f = self._eye_mixed(field.shape[0])
        f = eye_f
        emitted = []
        for k in (range(K, 0, -1) if transposed else range(1, K + 1)):
            lazy_U = f.U
            for l_rel in range(s_int):
                l = (k * s_int - l_rel if transposed
                     else (k - 1) * s_int + 1 + l_rel)
                e = self.exp_v_chain(field[:, l - 1])
                lazy_U = (bchain.bT_mult_left if transposed
                          else bchain.b_mult_left)(self.prop_chain, e, lazy_U,
                                                   checkerboard=cb)
            f = udv_refactor(lazy_U, f.d, f.V)
            emitted.append(f)
        parts = emitted[::-1] + [eye_f] if transposed else [eye_f] + emitted
        return UDV(*[torch.stack([getattr(p, leaf) for p in parts], dim=1)
                     for leaf in ("U", "d", "V")])

    def refresh_from_field(self, state: WalkerState) -> WalkerState:
        """Recompute the right stack and G(0) from the field alone."""
        return self.refresh_from_stack(
            state, self._build_stack(state.field, transposed=True))

    def refresh_from_stack(self, state: WalkerState, stack) -> WalkerState:
        """refresh_from_field's second half: G(0) and the sign from the
        transposed stack ``stack`` of ``state.field`` (entry 0 is the
        whole chain)."""
        stack = Stack(*stack)
        full_t = UDV(stack.U[:, 0], stack.d[:, 0], stack.V[:, 0])
        G = green_from_two_udv(self._eye_mixed(state.field.shape[0]),
                               full_t).to(self.dtype)
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
