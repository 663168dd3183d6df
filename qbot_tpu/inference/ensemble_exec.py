"""Device-side exact ensemble executor: mid-circuit measurement at scale.

The dense interpreter handles mid-circuit ``meas`` by collapsing the host
density matrix (reference semantics); this module is the device
equivalent for large registers: the register is a batch of weighted PURE
planar states (particles), and a measurement fans every particle out over
its outcomes —

    ψ_b → { P_k ψ_b / √p_bk  with weight  w_b · p_bk }  for each outcome k

— the exact ProbVal cartesian product, executed as one vmapped masked
projection (static shapes; no sampling).  The particle mixture
Σ w |ψ⟩⟨ψ| equals the interpreter's collapsed density at every step, while
memory stays B·2^n instead of 4^n.  The particle count is capped like
ProbVal's pruning: after each fan-out the top-``max_particles`` branches by
weight are kept and the weights renormalised (reference drops p < 1e-5,
probVal.py:7).

Used by :func:`qbot_tpu.frontend.lowering.run_lowered_ensemble` to execute
.qb programs with mid-circuit measurements on the device engine; also a
library API for circuit-level use.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from qbot_tpu.tpu.compiler import Plan

__all__ = ["QuantumEnsemble", "init_ensemble", "init_mixed_ensemble",
           "apply_plan_ensemble", "measure_fanout", "measure_sample",
           "discard_fanout", "discard_sample", "peek_probs",
           "concat_weighted", "ensemble_mixture", "MAX_PARTICLES"]

MAX_PARTICLES = 256
_MIN_P = 1e-12


class QuantumEnsemble(NamedTuple):
    """Weighted batch of planar pure states; exact branch semantics.

    ``lost_mass`` is the cumulative probability mass dropped by branch
    pruning so far — the exact error bound on every subsequent outcome
    probability (|p_reported − p_exact| ≤ lost_mass in total variation).
    Tracked so deep measurement programs cannot lose mass *silently*
    (executors surface it; see :func:`run_lowered_ensemble`).
    """
    log_w: jax.Array                 # (B,)
    psi: jax.Array                   # (B, 2, 2^n) planar float32
    lost_mass: jax.Array | float = 0.0   # cumulative pruned probability

    @property
    def num_particles(self) -> int:
        return self.log_w.shape[0]

    def weights(self) -> jax.Array:
        w = jnp.exp(self.log_w)
        return w / jnp.sum(w)


def init_ensemble(psi0: jax.Array) -> QuantumEnsemble:
    """Single-particle ensemble from a planar (2, 2^n) state."""
    return QuantumEnsemble(jnp.zeros((1,)), psi0[None])


_PRODUCT_BATCH_CACHE: dict = {}


def init_product_ensemble(kets, B: int = 1) -> QuantumEnsemble:
    """Uniform B-particle ensemble of the product state ⊗kets, built ON
    DEVICE (one jitted call; see planar.product_state_planar — the big
    array never crosses the host↔device boundary).  Used by the runners
    for register prep and for SMC-mode particle replication, replacing a
    host kron + state-sized device_put."""
    from qbot_tpu.tpu.planar import product_state_planar

    psi1 = product_state_planar(kets)
    if B == 1:
        return init_ensemble(psi1)
    key = ("tile", B, psi1.shape)
    fn = _PRODUCT_BATCH_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda p: jnp.broadcast_to(p[None], (B,) + p.shape))
        _PRODUCT_BATCH_CACHE[key] = fn
    # default float dtype (matches init_ensemble's zeros: f64 on x64 CPU
    # conformance runs, f32 on device)
    return QuantumEnsemble(jnp.full((B,), -np.log(B)), fn(psi1))


def _prune(log_w, psi, max_particles: int, lost_mass):
    """Keep the heaviest ``max_particles`` branches; renormalise.

    Returns (log_w, psi, lost_mass') with the cumulative pruned-mass
    accumulator updated: lost' = lost + retained_so_far · dropped_fraction.
    """
    total = log_w.shape[0]
    keep = min(max_particles, total)
    if keep < total:
        mass_before = jnp.sum(jnp.exp(log_w))
        log_w, idx = jax.lax.top_k(log_w, keep)
        psi = psi[idx]
        dropped = 1.0 - jnp.sum(jnp.exp(log_w)) / mass_before
        lost_mass = lost_mass + (1.0 - lost_mass) * dropped
    log_w = log_w - jax.scipy.special.logsumexp(log_w)
    return log_w, psi, lost_mass


def init_mixed_ensemble(rho: np.ndarray, tol: float = 1e-12
                        ) -> QuantumEnsemble:
    """Ensemble from a (possibly mixed) density matrix: its eigenensemble.

    ρ = Σ λᵢ|vᵢ⟩⟨vᵢ| becomes one particle per λᵢ > tol — mixed-state
    *preparation* at scale (the reference preps any ρ via qdef/qset,
    /root/reference/qbot/operators.py:133-166; the particle mixture keeps
    memory at B·2^n instead of 4^n).
    """
    rho = np.asarray(rho, complex)
    vals, vecs = np.linalg.eigh(rho)
    keep = vals > tol
    vals, vecs = vals[keep], vecs[:, keep]
    psi = np.stack([np.stack([vecs[:, i].real, vecs[:, i].imag])
                    for i in range(vals.shape[0])]).astype(np.float32)
    return QuantumEnsemble(jnp.log(jnp.asarray(vals / vals.sum())),
                           jnp.asarray(psi))


# Cached jitted executors (mirror of tpu/sharded_ensemble._JIT_CACHE):
# one dispatch per executor instead of one per jnp primitive.  The cache
# key carries every trace-time static (sizes, targets, mode, layout
# policy, dtypes); arrays and PRNG keys are arguments of the jitted
# callable.
_JIT_CACHE: dict = {}


def _cached_exec(key, body):
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(body)
        _JIT_CACHE[key] = fn
    return fn


def _layout_key():
    """Trace-time layout statics every executor key must carry."""
    return (_FORCE_SAFE,)


def _lost(ens: QuantumEnsemble):
    return jnp.asarray(ens.lost_mass, ens.log_w.dtype)


def apply_plan_ensemble(ens: QuantumEnsemble, plan: Plan,
                        params=None) -> QuantumEnsemble:
    from qbot_tpu.tpu.compiler import plan_cache_key
    from qbot_tpu.tpu.dotplan import dot_mode
    from qbot_tpu.tpu.planar import apply_plan_planar

    digest = plan_cache_key(plan) if params is None else None
    if digest is None:              # parameterised plan: not cacheable
        psi = jax.vmap(lambda p: apply_plan_planar(p, plan, params))(
            ens.psi)
        return QuantumEnsemble(ens.log_w, psi, ens.lost_mass)
    ck = ("ap", digest, ens.psi.shape, str(ens.psi.dtype), dot_mode())
    psi = _cached_exec(ck, lambda psi: jax.vmap(
        lambda p: apply_plan_planar(p, plan, None))(psi))(ens.psi)
    return QuantumEnsemble(ens.log_w, psi, ens.lost_mass)


# --- mask/carrier ("safe") collapse algebra --------------------------------
#
# The direct formulations view the state as (2,)*n and moveaxis the
# target axes: transposes of rank n+2.  XLA's GPU backend did not finish
# compiling the exact fan-out executors built on them within minutes at
# 24 qubits (PERF.md), so registers of _MASK_N_MIN qubits or more use the
# mask/carrier formulations, which keep every array at rank <= 5 by
# computing each split through broadcast BIT MASKS over a (2, F, S, L)
# carrier view:
#   * outcome probabilities — one grouped-view reduction (reductions
#     never materialise their operand view);
#   * collapsed states (measure) — the projector IS a diagonal mask:
#     psi * mask_k / sqrt(p_k), applied in the original layout;
#   * sub-block extraction (disc) — sum over target axes of the masked
#     state;
#   * block relocation / tensor insertion — broadcast products reshaped
#     to the carrier at the materialisation point.

_MASK_N_MIN = 14          # below this, (2,)*n views are cheap and exact
# None selects the formulation from the register width; True / False pin
# the mask/carrier or the direct one (tests pin both to each other)
_FORCE_SAFE: Optional[bool] = None


def _safe_layouts(n: int, t: int = 0) -> bool:
    """Use the mask/carrier collapse formulations for this register?"""
    if n < _MASK_N_MIN or t > 12:
        return False
    return True if _FORCE_SAFE is None else _FORCE_SAFE


def _local_tail(n: int):
    lane = min(n, 7)
    sub = min(3, n - lane)
    return n - sub - lane, sub, lane


def _carrier(n: int):
    f, s, l = _local_tail(n)
    return (2 ** f, 2 ** s, 2 ** l)


def _outcome_mask(n: int, targets, k: int):
    """(F, S, L)-broadcast constant selecting target bits == k (host
    per-axis 0/1 vectors, outer product assembled in trace)."""
    f, s, l = _local_tail(n)
    sizes = (2 ** f, 2 ** s, 2 ** l)
    spans = ((0, f), (f, f + s), (f + s, n))
    vecs = [np.ones(sz, np.float32) for sz in sizes]
    t = len(targets)
    for i, q in enumerate(targets):
        want = (k >> (t - 1 - i)) & 1
        for ax, (lo, hi) in enumerate(spans):
            if lo <= q < hi:
                ar = np.arange(sizes[ax])
                bit = (ar >> (hi - 1 - q)) & 1
                vecs[ax] *= (bit == want).astype(np.float32)
                break
    F, S, L = sizes
    return (jnp.asarray(vecs[0]).reshape(F, 1, 1)
            * jnp.asarray(vecs[1]).reshape(1, S, 1)
            * jnp.asarray(vecs[2]).reshape(1, 1, L))


def _probs_by_reduce(psi, n: int, targets):
    """(K,) outcome probabilities of the (sorted-)target bits.

    Large registers use a mask-factor einsum chain over the (F, S, L)
    carrier — p_k = Σ m_f[k,f]·m_s[k,s]·m_l[k,l]·|ψ|²[f,s,l] — instead
    of reducing a rank-n (2,)*n view, keeping every operand in the
    carrier's (>= 8, >= 128) trailing dims.  K is tiny, so the chain
    costs ~K extra reads of nothing (three skinny dots).
    """
    srt = sorted(targets)
    if n >= _MASK_N_MIN:
        mf, ms, ml = _mask_factor_rows(n, srt)    # (K,F),(K,S),(K,L)
        F, S, L = _carrier(n)
        sq = (psi[0] ** 2 + psi[1] ** 2).reshape(F, S, L)
        t = jnp.einsum("kf,fsl->ksl", mf, sq,
                       precision=jax.lax.Precision.HIGHEST)
        t = jnp.einsum("ks,ksl->kl", ms, t,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum("kl,kl->k", ml, t,
                          precision=jax.lax.Precision.HIGHEST)
    sq = psi[0] ** 2 + psi[1] ** 2
    v = sq.reshape((2,) * n)
    other = tuple(a for a in range(n) if a not in set(srt))
    p = jnp.sum(v, axis=other) if other else v
    return p.reshape(-1)


def _mask_factor_rows(n: int, targets):
    """Host (K, F), (K, S), (K, L) matrices: row k's outer product is the
    bit mask selecting target bits == k.  Lets sample-mode collapses
    select ONE outcome's mask per particle (small row gathers) instead of
    materialising all K projected states (K× the ensemble memory)."""
    f, s, l = _local_tail(n)
    sizes = (2 ** f, 2 ** s, 2 ** l)
    spans = ((0, f), (f, f + s), (f + s, n))
    t = len(targets)
    K = 2 ** t
    mats = [np.ones((K, sz), np.float32) for sz in sizes]
    for i, q in enumerate(targets):
        want = ((np.arange(K) >> (t - 1 - i)) & 1)[:, None]   # (K, 1)
        for ax, (lo, hi) in enumerate(spans):
            if lo <= q < hi:
                bit = ((np.arange(sizes[ax]) >> (hi - 1 - q)) & 1)[None, :]
                mats[ax] *= (bit == want).astype(np.float32)
                break
    return tuple(jnp.asarray(m) for m in mats)


def _select_mask(mrows, n: int, outcome):
    """The (F, S, L)-broadcast mask of ONE (traced) outcome index."""
    F, S, L = _carrier(n)
    mf, ms, ml = mrows
    return (mf[outcome].reshape(F, 1, 1) * ms[outcome].reshape(1, S, 1)
            * ml[outcome].reshape(1, 1, L))


def _outcome_split(psi, n: int, targets: Sequence[int]):
    """(2, 2^n) → per-outcome probs (K,) and collapsed states (K, 2, 2^n).

    Computation-basis outcomes of ``targets`` (sorted); collapsed states
    are renormalised projections P_k ψ / √p_k.
    """
    targets = sorted(targets)
    t = len(targets)
    K = 2**t
    if _safe_layouts(n, t):
        F, S, L = _carrier(n)
        p = _probs_by_reduce(psi, n, targets)
        inv = 1.0 / jnp.sqrt(jnp.clip(p, _MIN_P))
        pv = psi.reshape(2, F, S, L)
        proj = jnp.stack([pv * (_outcome_mask(n, targets, k) * inv[k])
                          for k in range(K)])
        return p, proj.reshape(K, 2, -1)
    pt = psi.reshape((2,) + (2,) * n)
    pt = jnp.moveaxis(pt, [1 + q for q in targets], list(range(1, 1 + t)))
    pt = pt.reshape(2, K, -1)                     # (2, K, rest)
    p = jnp.sum(pt**2, axis=(0, 2))               # (K,)
    eye = jnp.eye(K, dtype=psi.dtype)
    proj = jnp.einsum("kj,cjr->kcjr", eye, pt)    # (K, 2, K, rest)
    norm = jnp.sqrt(jnp.clip(p, _MIN_P))[:, None, None, None]
    proj = proj / norm
    proj = proj.reshape((K, 2) + (2,) * n)
    proj = jnp.moveaxis(proj, list(range(2, 2 + t)),
                        [2 + q for q in targets])
    return p, proj.reshape(K, 2, -1)


def peek_probs(ens: QuantumEnsemble, n: int, targets: Sequence[int]
               ) -> jax.Array:
    """Ensemble-marginal outcome distribution, no state change."""
    from qbot_tpu.tpu.planar import planar_probs

    srt = sorted(targets)

    def body(log_w0, psi0):
        per = jax.vmap(lambda p: planar_probs(p, srt, n))(psi0)
        w = jnp.exp(log_w0)
        return (w / jnp.sum(w)) @ per

    ck = ("pk", n, tuple(srt), ens.psi.shape, str(ens.psi.dtype),
          str(ens.log_w.dtype), _layout_key())
    return _cached_exec(ck, body)(ens.log_w, ens.psi)


def _cyclic_shift(x, m: int, k: int):
    """Rotate the m qubit axes of a (..., 2^m) tensor left by k positions
    via ONE transpose (..., 2^k, 2^{m-k}) → (..., 2^{m-k}, 2^k).

    Callers request shifts in [7, m-3] only, so both transposed dims
    hold at least 2^3 and 2^7 entries."""
    lead = x.shape[:-1]
    off = len(lead)
    v = x.reshape(lead + (2 ** k, 2 ** (m - k)))
    v = jnp.swapaxes(v, off, off + 1)
    return v.reshape(lead + (-1,))


def _shift_amounts(s: int, m: int):
    """Decompose a cyclic left-shift by ``s`` (mod m) into shifts each in
    the range [7, m-3] (terminates for m >= 16: s < 7 pushes
    to s+m-7, whose overshoot of m-3 is at least 7 again)."""
    out = []
    s %= m
    while s:
        if 7 <= s <= m - 3:
            out.append(s)
            s = 0
        elif s < 7:
            out.append(7)
            s = (s - 7) % m
        else:                          # s > m-3: peel off a safe shift
            out.append(s - 7)
            s = 7
    return out


def _sum_over_targets(x, n: int, targets):
    """Sum a (..., 2^n) tensor over the target qubit axes, in the
    original order of the remaining axes.

    Above the small-n regime a naive reduction materialises its output
    in (2,)*m form.  Instead, axes are eliminated one
    at a time from SAFE positions (3 <= p <= m-8, so the reduce output
    (..., A, B) keeps A >= 8, B >= 128), cycling the register with safe
    transposes (:func:`_cyclic_shift`) when no target sits in the safe
    band; removals preserve cyclic order, so the final order is a pure
    cyclic shift of the desired order and one or two safe shifts restore
    it.  Each shift costs a full-state pass; disc/replace events are
    rare.
    """
    # below _STAGED_MIN the direct (2,)*m reduction is used: the staged
    # rotation scheme needs m >= 17 for its safe band [3, m-8] to be
    # reachable from every position (at m = 14 positions 0-2 and 7-9
    # cycle forever under rotate-by-7)
    _STAGED_MIN = 17
    lead = x.shape[:-1]
    off = len(lead)
    tset = set(targets)
    if n < _STAGED_MIN or not _safe_layouts(n):
        v = x.reshape(lead + (2,) * n)
        v = jnp.sum(v, axis=tuple(off + q for q in targets))
        return v.reshape(lead + (-1,))
    order = list(range(n))
    m = n
    remaining = set(targets)
    cur = x.reshape(lead + (-1,))
    while remaining:
        if m < _STAGED_MIN:           # small enough: finish directly
            pos_of = {q: i for i, q in enumerate(order)}
            v = cur.reshape(lead + (2,) * m)
            v = jnp.sum(v, axis=tuple(off + pos_of[q] for q in remaining))
            order = [q for q in order if q not in remaining]
            m = len(order)
            remaining = set()
            cur = v.reshape(lead + (-1,))
            break
        pos_of = {q: i for i, q in enumerate(order)}
        safe = sorted((pos_of[q] for q in remaining
                       if 3 <= pos_of[q] <= m - 8), reverse=True)
        if safe:
            p = safe[0]
            q = order[p]
            A, B = 2 ** p, 2 ** (m - 1 - p)
            v = cur.reshape(lead + (A, 2, B))
            v = jnp.sum(v, axis=off + 1)
            cur = v.reshape(lead + (-1,))
            order.pop(p)
            m -= 1
            remaining.discard(q)
            continue
        cur = _cyclic_shift(cur, m, m - 7)   # move the last 7 to front
        order = order[m - 7:] + order[:m - 7]
    desired = [q for q in range(n) if q not in tset]
    if order != desired and m:
        if m < _STAGED_MIN:
            pos_of = {q: i for i, q in enumerate(order)}
            v = cur.reshape(lead + (2,) * m)
            v = jnp.transpose(v, tuple(range(off))
                              + tuple(off + pos_of[q] for q in desired))
            cur = v.reshape(lead + (-1,))
        else:
            # order is a cyclic shift of desired (removals preserve
            # cyclic words): restore with safe shifts
            s = order.index(desired[0])
            for k in _shift_amounts(s, m):
                cur = _cyclic_shift(cur, m, k)
    return cur


def _expand_over_targets(phi, n: int, targets):
    """Broadcast a (..., 2^{n-t}) tensor over the target qubit axes to
    (..., F, S, L) carrier form (the broadcast+reshape fuse into the
    consuming multiply, so nothing materialises at rank n)."""
    tset = set(targets)
    lead = phi.shape[:-1]
    shape = lead + tuple(1 if q in tset else 2 for q in range(n))
    full = lead + (2,) * n
    F, S, L = _carrier(n)
    return jnp.broadcast_to(phi.reshape(shape), full).reshape(
        lead + (F, S, L))


def _replace_block(state, n: int, targets: Sequence[int], k: int):
    """|k⟩_A ⊗ (B-part of ``state``): zero all target-blocks except the
    B-slice of the state's own block, relocated to block ``k``."""
    targets = sorted(targets)
    t = len(targets)
    K = 2**t
    if _safe_layouts(n, t):
        phi = _sum_over_targets(state, n, targets)   # (2, 2^{n-t})
        out = (_expand_over_targets(phi, n, targets)
               * _outcome_mask(n, targets, k))
        return out.reshape(state.shape)
    pt = state.reshape((2,) + (2,) * n)
    pt = jnp.moveaxis(pt, [1 + q for q in targets], list(range(1, 1 + t)))
    pt = pt.reshape(2, K, -1)
    phi = jnp.sum(pt, axis=1)            # collapsed states have ONE nonzero
    out = jnp.zeros_like(pt).at[:, k, :].set(phi)
    out = out.reshape((2, K) + (2,) * (n - t))
    out = out.reshape((2,) + (2,) * n)
    out = jnp.moveaxis(out, list(range(1, 1 + t)), [1 + q for q in targets])
    return out.reshape(state.shape)


def measure_fanout(ens: QuantumEnsemble, n: int, targets: Sequence[int],
                   max_particles: int = MAX_PARTICLES,
                   mode: str = "reference"
                   ) -> tuple[QuantumEnsemble, jax.Array]:
    """Measure + collapse: fan particles over outcomes, prune to the
    ``max_particles`` heaviest branches, renormalise.

    ``mode="projective"``: textbook update ρ → Σ_k P_k ρ P_k — each
    particle fans K ways into |k⟩_A ⊗ φ_k with weight w·p_k, preserving
    classical outcome↔rest correlations.

    ``mode="reference"`` (default): the reference interpreter's semantics
    (measurement.py:154-163): the measured subsystem is REPLACED by the
    outcome mixture and decoupled from the rest, ρ → Tr_A(ρ) ⊗ Σ p_k P_k.
    As pure states that is the K² fan-out |k⟩_A ⊗ φ_j with weight
    w·p_j·p_k (the j=k diagonal is the projective case).

    Returns (new ensemble, outcome distribution (K,) before pruning).
    """
    if mode not in ("projective", "reference"):
        raise ValueError(f"unknown collapse mode {mode!r}")
    B = ens.num_particles
    K = 2 ** len(targets)

    def body(log_w0, psi0, lost0):
        p_all, states = jax.vmap(
            lambda s: _outcome_split(s, n, targets))(psi0)  # (B,K),(B,K,2,·)
        w = jnp.exp(log_w0)
        dist = (w / jnp.sum(w)) @ p_all
        logp = jnp.log(jnp.clip(p_all, _MIN_P))

        if mode == "projective":
            log_w = (log_w0[:, None] + logp).reshape(B * K)
            psi = states.reshape((B * K, 2) + states.shape[3:])
        else:
            # relocate branch j's B-part into every outcome block k
            relocated = jax.vmap(jax.vmap(
                lambda s: jax.vmap(
                    lambda k: _replace_block(s, n, targets, k)
                )(jnp.arange(K))))(states)        # (B, K_j, K_k, 2, ·)
            log_w = (log_w0[:, None, None] + logp[:, :, None]
                     + logp[:, None, :]).reshape(B * K * K)
            psi = relocated.reshape((B * K * K, 2) + states.shape[3:])

        return (*_prune(log_w, psi, max_particles, lost0), dist)

    ck = ("mf", n, tuple(targets), max_particles, mode, ens.psi.shape,
          str(ens.psi.dtype), str(ens.log_w.dtype), _layout_key())
    log_w, psi, lost, dist = _cached_exec(ck, body)(
        ens.log_w, ens.psi, _lost(ens))
    return QuantumEnsemble(log_w, psi, lost), dist


def _discard_split(psi, n: int, targets: Sequence[int]):
    """(2, 2^n) → per-outcome probs (K,) and SHRUNK states (K, 2, 2^{n-t}).

    Tracing out ``targets`` of a pure state: Tr_A |ψ⟩⟨ψ| = Σ_a p_a
    |φ_a⟩⟨φ_a| with φ_a = ⟨a|ψ⟩/√p_a — the discarded axes are consumed,
    so the returned states live on the remaining n−t qubits.
    """
    targets = sorted(targets)
    t = len(targets)
    K = 2**t
    if _safe_layouts(n, t):
        F, S, L = _carrier(n)
        p = _probs_by_reduce(psi, n, targets)
        inv = 1.0 / jnp.sqrt(jnp.clip(p, _MIN_P))
        pv = psi.reshape(2, F, S, L)
        states = jnp.stack([
            _sum_over_targets(
                (pv * (_outcome_mask(n, targets, k) * inv[k])
                 ).reshape(2, -1), n, targets)
            for k in range(K)])
        return p, states                          # (K, 2, 2^{n-t})
    pt = psi.reshape((2,) + (2,) * n)
    pt = jnp.moveaxis(pt, [1 + q for q in targets], list(range(1, 1 + t)))
    pt = pt.reshape(2, K, -1)                     # (2, K, rest)
    p = jnp.sum(pt**2, axis=(0, 2))               # (K,)
    norm = jnp.sqrt(jnp.clip(p, _MIN_P))[None, :, None]
    states = jnp.moveaxis(pt / norm, 1, 0)        # (K, 2, 2^{n-t})
    return p, states


def discard_fanout(ens: QuantumEnsemble, n: int, targets: Sequence[int],
                   max_particles: int = MAX_PARTICLES
                   ) -> QuantumEnsemble:
    """``disc`` at scale: partial-trace the targets out of the mixture.

    Device twin of the reference's partial trace
    (/root/reference/qbot/operators.py:169-188, density.py:122-148): each
    particle fans out over the discarded subsystem's basis states, the axes
    are dropped, and the heaviest ``max_particles`` branches are kept —
    Σ w|ψ⟩⟨ψ| equals Tr_A of the pre-discard mixture exactly (up to the
    prune).  The register shrinks by len(targets) qubits.
    """
    B = ens.num_particles
    K = 2 ** len(targets)

    def body(log_w0, psi0, lost0):
        p_all, states = jax.vmap(
            lambda s: _discard_split(s, n, targets))(psi0)
        logp = jnp.log(jnp.clip(p_all, _MIN_P))
        log_w = (log_w0[:, None] + logp).reshape(B * K)
        psi = states.reshape((B * K, 2) + states.shape[3:])
        return _prune(log_w, psi, max_particles, lost0)

    ck = ("df", n, tuple(sorted(targets)), max_particles, ens.psi.shape,
          str(ens.psi.dtype), str(ens.log_w.dtype), _layout_key())
    log_w, psi, lost = _cached_exec(ck, body)(
        ens.log_w, ens.psi, _lost(ens))
    return QuantumEnsemble(log_w, psi, lost)


def discard_sample(key: jax.Array, ens: QuantumEnsemble, n: int,
                   targets: Sequence[int], ess_threshold: float = 0.5
                   ) -> QuantumEnsemble:
    """SMC-mode ``disc``: sample ONE traced-out basis state per particle
    (optimal Born proposal, constant particle count), dropping the axes."""
    from qbot_tpu.inference.smc import (
        Ensemble as WEnsemble,
        effective_sample_size,
        systematic_resample,
    )

    B = ens.num_particles
    targets = sorted(targets)
    t = len(targets)
    safe = _safe_layouts(n, t)

    def body(rngkey, log_w0, psi0):
        if safe:
            # large registers: extract only the SAMPLED outcome's
            # sub-block (mask + staged sum), never the all-K states tensor
            p_all = jax.vmap(
                lambda s: _probs_by_reduce(s, n, targets))(psi0)
            key_o, key_r = jax.random.split(rngkey)
            outcomes = jax.random.categorical(
                key_o, jnp.log(jnp.clip(p_all, _MIN_P)), axis=-1)
            p_sel = jnp.take_along_axis(p_all, outcomes[:, None],
                                        axis=1)[:, 0]
            inv = 1.0 / jnp.sqrt(jnp.clip(p_sel, _MIN_P))
            mrows = _mask_factor_rows(n, targets)
            F, S, L = _carrier(n)

            def extract(s, o, iv):
                m = _select_mask(mrows, n, o)
                masked = (s.reshape(2, F, S, L) * (m * iv)).reshape(2, -1)
                return _sum_over_targets(masked, n, targets)

            psi = jax.vmap(extract)(psi0, outcomes, inv)
        else:
            p_all, states = jax.vmap(
                lambda s: _discard_split(s, n, targets))(psi0)
            key_o, key_r = jax.random.split(rngkey)
            outcomes = jax.random.categorical(
                key_o, jnp.log(jnp.clip(p_all, _MIN_P)), axis=-1)
            psi = jnp.take_along_axis(
                states, outcomes[:, None, None, None], axis=1)[:, 0]
        ess = effective_sample_size(log_w0)

        def do_resample(_):
            r = systematic_resample(key_r, WEnsemble(log_w0, psi))
            return r.log_weights, r.values

        def skip(_):
            return log_w0, psi

        return jax.lax.cond(ess < ess_threshold * B, do_resample, skip,
                            None)

    ck = ("ds", n, tuple(targets), float(ess_threshold), ens.psi.shape,
          str(ens.psi.dtype), str(ens.log_w.dtype), _layout_key())
    log_w, psi = _cached_exec(ck, body)(key, ens.log_w, ens.psi)
    return QuantumEnsemble(log_w, psi, ens.lost_mass)


def measure_sample(key: jax.Array, ens: QuantumEnsemble, n: int,
                   targets: Sequence[int], ess_threshold: float = 0.5
                   ) -> tuple[QuantumEnsemble, jax.Array, jax.Array]:
    """SMC-mode measurement: SAMPLE one outcome per particle instead of
    fanning out — the particle count stays constant, so arbitrarily deep
    measurement sequences run at fixed memory (the scalable regime the
    exact fan-out's exponential branch growth cannot reach).

    Outcomes are drawn from each particle's own Born distribution, which is
    exactly the optimal SMC proposal: incremental importance weights are
    constant, so weights stay untouched and degeneracy only enters through
    earlier weight structure — systematic resampling triggers when
    ESS < threshold·B.

    Returns (new ensemble, marginal outcome distribution (K,) before
    sampling, sampled outcomes (B,)).
    """
    from qbot_tpu.inference.smc import (
        Ensemble as WEnsemble,
        effective_sample_size,
        systematic_resample,
    )

    B = ens.num_particles
    targets = sorted(targets)
    t = len(targets)
    safe = _safe_layouts(n, t)

    def body(rngkey, log_w0, psi0):
        if safe:
            # large registers: select ONE outcome's mask per particle —
            # the all-K projected-states tensor is K× the ensemble memory
            p_all = jax.vmap(
                lambda s: _probs_by_reduce(s, n, targets))(psi0)
            key_o, key_r = jax.random.split(rngkey)
            outcomes = jax.random.categorical(
                key_o, jnp.log(jnp.clip(p_all, _MIN_P)), axis=-1)
            p_sel = jnp.take_along_axis(p_all, outcomes[:, None],
                                        axis=1)[:, 0]
            inv = 1.0 / jnp.sqrt(jnp.clip(p_sel, _MIN_P))
            mrows = _mask_factor_rows(n, targets)
            F, S, L = _carrier(n)

            def collapse(s, o, iv):
                m = _select_mask(mrows, n, o)
                return (s.reshape(2, F, S, L) * (m * iv)).reshape(2, -1)

            psi = jax.vmap(collapse)(psi0, outcomes, inv)
        else:
            p_all, states = jax.vmap(
                lambda s: _outcome_split(s, n, targets))(psi0)
            key_o, key_r = jax.random.split(rngkey)
            outcomes = jax.random.categorical(
                key_o, jnp.log(jnp.clip(p_all, _MIN_P)), axis=-1)  # (B,)
            psi = jnp.take_along_axis(
                states, outcomes[:, None, None, None], axis=1)[:, 0]
        w = jnp.exp(log_w0)
        dist = (w / jnp.sum(w)) @ p_all

        ess = effective_sample_size(log_w0)

        def do_resample(_):
            r = systematic_resample(key_r, WEnsemble(log_w0,
                                                     (psi, outcomes)))
            return r.log_weights, r.values[0], r.values[1]

        def skip(_):
            return log_w0, psi, outcomes

        log_w, psi_o, outs = jax.lax.cond(
            ess < ess_threshold * B, do_resample, skip, None)
        return log_w, psi_o, outs, dist

    ck = ("ms", n, tuple(targets), float(ess_threshold), ens.psi.shape,
          str(ens.psi.dtype), str(ens.log_w.dtype), _layout_key())
    log_w, psi, outcomes, dist = _cached_exec(ck, body)(
        key, ens.log_w, ens.psi)
    return QuantumEnsemble(log_w, psi, ens.lost_mass), dist, outcomes


def _expand_phi_over_others(vec, n: int, targets):
    """(2^t,) tensor living on ``targets`` (vec bit j ↔ targets[j]) →
    (F, S, L) carrier broadcast over the non-target axes.  The small
    transpose into sorted-target order happens on the 2^t tensor; the
    full-size broadcast+reshape fuse into the consuming multiply."""
    t = len(targets)
    order = np.argsort(np.asarray(targets))
    v = vec.reshape((2,) * t)
    if list(order) != list(range(t)):
        v = jnp.transpose(v, tuple(int(a) for a in order))
    tset = set(targets)
    shape = tuple(2 if q in tset else 1 for q in range(n))
    F, S, L = _carrier(n)
    return jnp.broadcast_to(v.reshape(shape), (2,) * n).reshape(F, S, L)


def _insert_block(phi_planar, rest, n: int, targets: Sequence[int]):
    """Tensor a 2^t planar ket into positions ``targets`` of an
    (n−t)-qubit planar ``rest`` — ``phi``'s qubit j lands on
    ``targets[j]`` (reference ``replaceArbitrary`` order, generalised to
    unsorted target lists like :func:`qbot_tpu.ops.core.replace_qubits`).
    """
    t = len(targets)
    pr, pi = phi_planar[0], phi_planar[1]
    rr, ri = rest[0], rest[1]
    if _safe_layouts(n, t):
        sorted_t = sorted(targets)
        pre = _expand_phi_over_others(pr, n, list(targets))
        pie = _expand_phi_over_others(pi, n, list(targets))
        rre = _expand_over_targets(rr[None], n, sorted_t)[0]
        rie = _expand_over_targets(ri[None], n, sorted_t)[0]
        out_r = pre * rre - pie * rie
        out_i = pre * rie + pie * rre
        return jnp.stack([out_r, out_i]).reshape(2, -1)
    out_r = pr[:, None] * rr[None, :] - pi[:, None] * ri[None, :]
    out_i = pr[:, None] * ri[None, :] + pi[:, None] * rr[None, :]
    o = jnp.stack([out_r, out_i]).reshape((2,) + (2,) * n)
    o = jnp.moveaxis(o, list(range(1, 1 + t)),
                     [1 + q for q in targets])
    return o.reshape(2, -1)


def replace_fanout(ens: QuantumEnsemble, n: int, targets: Sequence[int],
                   new_states, max_particles: int = MAX_PARTICLES
                   ) -> QuantumEnsemble:
    """Targeted ``qset`` at scale: replace the ``targets`` qubits with a
    new state (reference semantics: /root/reference/qbot/operators.py:
    133-166 via density.replaceArbitrary, density.py:194-216).

    On the pure-state particle ensemble this is a partial trace plus a
    tensor insertion: each particle fans out over the traced subsystem's
    basis states (exactly :func:`discard_fanout`) and each fan branch is
    tensored with each eigen-branch of the new state at the SAME qubit
    positions — Σ w p_k v_b |χ_b ⊗ φ_k⟩ equals ``replaceArbitrary`` of
    the pre-replace mixture exactly (up to the tracked prune).  The
    register width is unchanged.

    ``new_states``: ((weight, planar_ket 2×2^t), …) — the eigen-ensemble
    of the new state (a pure new state is a single branch).
    """
    B = ens.num_particles
    sorted_t = sorted(targets)
    K = 2 ** len(targets)
    phis = [(float(w), np.asarray(phi)) for w, phi in new_states]

    def body(log_w0, psi0, lost0):
        p_all, states = jax.vmap(
            lambda s: _discard_split(s, n, sorted_t))(psi0)
        logp = jnp.log(jnp.clip(p_all, _MIN_P))   # (B, K)
        parts_w, parts_psi = [], []
        for wb, phi in phis:
            ins = jax.vmap(jax.vmap(
                lambda s: _insert_block(jnp.asarray(phi, psi0.dtype), s,
                                        n, list(targets))))(states)
            parts_psi.append(ins.reshape((B * K, 2, -1)))
            parts_w.append((log_w0[:, None] + logp
                            + float(np.log(wb))).reshape(B * K))
        log_w = jnp.concatenate(parts_w)
        psi = jnp.concatenate(parts_psi)
        return _prune(log_w, psi, max_particles, lost0)

    ck = ("rf", n, tuple(targets), max_particles, ens.psi.shape,
          str(ens.psi.dtype), str(ens.log_w.dtype), _layout_key(),
          tuple((w, phi.tobytes()) for w, phi in phis))
    log_w, psi, lost = _cached_exec(ck, body)(
        ens.log_w, ens.psi, _lost(ens))
    return QuantumEnsemble(log_w, psi, lost)


def replace_sample(key: jax.Array, ens: QuantumEnsemble, n: int,
                   targets: Sequence[int], new_states) -> QuantumEnsemble:
    """SMC-mode targeted ``qset`` (VERDICT r4 #5): constant particle
    count — per particle, sample ONE traced-out basis state of the
    target subsystem (the optimal Born proposal, exactly as
    :func:`discard_sample`) and ONE eigen-branch of the new state (an
    exact categorical over its static weights), then tensor the branch
    ket back in at the target positions.  Both draws sample their
    distributions exactly, so importance weights are untouched; the
    particle mixture is an unbiased estimate of the reference's
    ``replaceArbitrary`` update (/root/reference/qbot/operators.py:
    133-166).
    """
    B = ens.num_particles
    sorted_t = sorted(targets)
    t = len(targets)
    phis = [(float(w), np.asarray(phi, np.float32)) for w, phi in new_states]
    logits = np.log(np.asarray([w for w, _ in phis], np.float32))
    phi_arr = np.stack([p for _, p in phis])      # (NB, 2, 2^t)
    safe = _safe_layouts(n, t)

    def body(rngkey, psi0):
        key_o, key_b = jax.random.split(rngkey)
        if safe:
            p_all = jax.vmap(
                lambda s: _probs_by_reduce(s, n, sorted_t))(psi0)
            outcomes = jax.random.categorical(
                key_o, jnp.log(jnp.clip(p_all, _MIN_P)), axis=-1)
            p_sel = jnp.take_along_axis(p_all, outcomes[:, None],
                                        axis=1)[:, 0]
            inv = 1.0 / jnp.sqrt(jnp.clip(p_sel, _MIN_P))
            mrows = _mask_factor_rows(n, sorted_t)
            F, S, L = _carrier(n)

            def extract(s, o, iv):
                m = _select_mask(mrows, n, o)
                masked = (s.reshape(2, F, S, L) * (m * iv)).reshape(2, -1)
                return _sum_over_targets(masked, n, sorted_t)

            rests = jax.vmap(extract)(psi0, outcomes, inv)
        else:
            p_all, states = jax.vmap(
                lambda s: _discard_split(s, n, sorted_t))(psi0)
            outcomes = jax.random.categorical(
                key_o, jnp.log(jnp.clip(p_all, _MIN_P)), axis=-1)
            rests = jnp.take_along_axis(
                states, outcomes[:, None, None, None], axis=1)[:, 0]
        draws = jax.random.categorical(
            key_b, jnp.asarray(logits), shape=(B,))
        phi_b = jnp.asarray(phi_arr, psi0.dtype)[draws]   # (B, 2, 2^t)
        return jax.vmap(
            lambda ph, r: _insert_block(ph, r, n, list(targets))
        )(phi_b, rests)

    ck = ("rs", n, tuple(targets), ens.psi.shape, str(ens.psi.dtype),
          _layout_key(),
          tuple((w, p.tobytes()) for w, p in phis))
    psi = _cached_exec(ck, body)(key, ens.psi)
    return QuantumEnsemble(ens.log_w, psi, ens.lost_mass)


def concat_resampled(key: jax.Array, weighted, B: int) -> QuantumEnsemble:
    """Weight-concatenate [(p, QuantumEnsemble)] and systematically
    resample back down to ``B`` particles — the SMC-mode mixture of
    per-branch ensembles (ProbVal ``disc``/``qset`` branch fan-out at
    constant memory).  Systematic resampling is unbiased for every
    mixture expectation; total weight is conserved (uniform over the
    survivors), and ``lost_mass`` combines as the p-weighted bound.
    """
    log_w = jnp.concatenate(
        [q.log_w + float(np.log(p)) for p, q in weighted])
    psi = jnp.concatenate([q.psi for _, q in weighted])
    total = sum(p for p, _ in weighted)
    lost = sum(p * jnp.asarray(q.lost_mass, log_w.dtype)
               for p, q in weighted) / total

    def body(rngkey, lw, ps):
        m = jnp.max(lw)
        w = jnp.exp(lw - m)
        z = jnp.sum(w)
        wn = w / jnp.clip(z, _MIN_P)
        u = (jax.random.uniform(rngkey, ()) + jnp.arange(B)) / B
        idx = jnp.clip(jnp.searchsorted(jnp.cumsum(wn), u), 0,
                       lw.shape[0] - 1)
        new_lw = jnp.full((B,), m + jnp.log(jnp.clip(z, _MIN_P))
                          - np.log(B), lw.dtype)
        return new_lw, ps[idx]

    ck = ("cr", B, psi.shape, str(psi.dtype), str(log_w.dtype))
    new_lw, new_psi = _cached_exec(ck, body)(key, log_w, psi)
    return QuantumEnsemble(new_lw, new_psi, lost)


def concat_weighted(weighted, max_particles: int = MAX_PARTICLES
                    ) -> QuantumEnsemble:
    """Weight-concatenate [(p, QuantumEnsemble)] into one pruned ensemble.

    ``lost_mass`` combines as the p-weighted mixture bound Σ pᵢεᵢ / Σ pᵢ
    before the prune accumulates on top.
    """
    log_w = jnp.concatenate(
        [q.log_w + float(np.log(p)) for p, q in weighted])
    psi = jnp.concatenate([q.psi for _, q in weighted])
    total = sum(p for p, _ in weighted)
    lost = sum(p * q.lost_mass for p, q in weighted) / total
    log_w, psi, lost = _prune(log_w, psi, max_particles, lost)
    return QuantumEnsemble(log_w, psi, lost)


def ensemble_mixture(ens: QuantumEnsemble) -> np.ndarray:
    """Σ w |ψ⟩⟨ψ| as a complex density matrix (host-side; conformance)."""
    w = np.asarray(ens.weights())
    psi = np.asarray(ens.psi)
    kets = psi[:, 0] + 1j * psi[:, 1]
    return np.einsum("b,bi,bj->ij", w, kets, np.conj(kets))
