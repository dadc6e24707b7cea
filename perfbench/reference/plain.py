"""The plain reference of a run: the same realizations as the program's
timed path, worked out again from the configuration and the run's seed.

A run of the program draws its randomness from its seed in three ways,
and this module draws the same numbers by the same recipes:

* the two seeds of a run (log-amplitude, screens) and the log-amplitude
  series: ``torch.Generator`` on the CPU seeded by the run's seed, two
  ``randint`` draws, then ``randn`` of the series (iid), or a complex
  normal coloured by the temporal log-amplitude PSD through a centred FT;
* the iid screens' noise: Philox4x32-10 keyed by the screen seed, counter
  ``(row * N + col, draw, chunk, 0)``, two words a grid point, each
  turned into a unit-variance uniform from its top 24 bits and mixed
  along the rows by the fixed orthogonal matrix of ``default_rng(0x5EED)``
  ('mixed' noise), or into a Box-Muller pair ('gauss');
* the AR series: the initial Fourier state as a complex normal from a
  ``torch.Generator`` on the run device seeded by the screen seed, and
  the boiling noise from Philox keyed by the next draw of that generator,
  counter ``(mode, layer, step // 2, 2)``, words 0 and 1 at even steps, 2
  and 3 at odd ones.

On those numbers the reference computes the screens ``W X W^T`` and the
AR recursion in complex128 with full float64 products, the pupil-overlap
couplings, the log-amplitude factor and ``|.|^2`` times the diffraction
limit: the power in watts of each realization or step it is asked for.
``precision="bf16"`` computes the same in float32 with every product's
operands rounded to bfloat16: the control of ``perfbench/checks``.
Nothing here imports the program.
"""

import numpy as np
import torch

from .setup.ops.fourier import ft

_MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
# grid points of Philox words made at once (int64 temporaries of ~1 GB)
_POINTS = 1 << 24


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcast
    together) under the 64-bit key ``(k0, k1)``. The 64-bit product of two
    32-bit words wraps in int64 with its bits intact, so its high and low
    words are read off it directly."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0 = (k0 + _W[0]) & _MASK32
            k1 = (k1 + _W[1]) & _MASK32
        p0 = c0 * _M[0]
        p1 = c2 * _M[1]
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def key(seed):
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32


def uniforms(bits):
    """Unit-variance uniforms from the top 24 bits of 32-bit words, the
    float32 values ``(bits >> 8) * sqrt(3) 2^-23 - sqrt(3)`` exactly."""
    s3 = np.float32(np.sqrt(3.0))
    scale = float(s3 * np.float32(2.0 ** -23))
    return ((bits >> 8).to(torch.float32) * scale - float(s3))


def box_muller(b1, b2):
    """A Box-Muller pair from two words' top 24 bits, ``u1 = i1 2^-24 +
    2^-25``, ``u2 = i2 2^-24`` (float32), in float64."""
    u1 = ((b1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25).double()
    u2 = ((b2 >> 8).to(torch.float32) * 2.0 ** -24).double()
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = 2 * np.pi * u2
    return r * torch.cos(t), r * torch.sin(t)


def mixing_matrix(n):
    """The fixed orthogonal mixing matrix of 'mixed' noise, float64."""
    rng = np.random.default_rng(0x5EED)
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


def run_seeds(seed):
    """(log-amplitude seed, screen seed) of a run of seed ``seed``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return tuple(int(torch.randint(0, 2 ** 63 - 1, (), generator=g))
                 for _ in range(2))


def logamp_series(seed, setup):
    """The log-amplitude series (NITER,) float64 of a run of seed
    ``seed``: iid normals of variance ``logamp_var``, or the temporal
    series coloured by the temporal log-amplitude PSD."""
    g = torch.Generator(device="cpu")
    g.manual_seed(run_seeds(seed)[0] & 0xFFFF_FFFF_FFFF_FFFF)
    n = setup.niter
    sd = float(np.sqrt(setup.logamp_var))
    if not setup.temporal:
        r = torch.randn((n,), generator=g, dtype=torch.float32)
        return r.double() * sd
    both = torch.randn((2, n), generator=g, dtype=torch.float32).double()
    ps = torch.as_tensor(setup.temporal_ps, dtype=torch.float64)
    r = torch.complex(both[0], both[1]) * torch.sqrt(ps / ps.sum())
    return ft(r, 1.0).real * sd


class Arith:
    """The arithmetic of one side: ``"float64"`` (the reference) or
    ``"bf16"`` (the control: float32, products on bfloat16 operands)."""

    def __init__(self, precision, device):
        if precision not in ("float64", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.bf16 = precision == "bf16"
        self.real = torch.float32 if self.bf16 else torch.float64
        self.cplx = torch.complex64 if self.bf16 else torch.complex128
        self.device = device

    def t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            dtype or self.real)

    def _round(self, x):
        if not self.bf16:
            return x
        if x.is_complex():
            return torch.complex(x.real.bfloat16().float(),
                                 x.imag.bfloat16().float())
        return x.bfloat16().float()

    def mm(self, a, b):
        """``a @ b`` on the side's operands, accumulated in its type."""
        return self._round(a) @ self._round(b)


def _couplings(phs, pm, scale):
    """``(sum pm cos phs + i sum pm sin phs) * scale`` over the last two
    axes."""
    return torch.complex((pm * torch.cos(phs)).sum((-2, -1)),
                         (pm * torch.sin(phs)).sum((-2, -1))) * scale


def iid_powers(setup, seed, nchunks, picks, noise="mixed",
               precision="float64", device="cpu"):
    """Power in watts of chosen realizations of an iid run of seed
    ``seed`` cut into ``nchunks`` chunks.

    ``picks``: int array of global realization indices. Realization ``j``
    of chunk ``i = j // B`` (B = NITER / nchunks) is the screen from the
    real part of draw ``j % B`` of the chunk where that is below ``B / 2``,
    else from the imaginary part of draw ``j % B - B / 2``.
    Returns a float64 numpy array of the picks' powers.
    """
    ar = Arith(precision, device)
    _, seed_mc = run_seeds(seed)
    k0, k1 = key(seed_mc)
    N = setup.N
    B = setup.niter // nchunks
    nb = B // 2
    picks = np.asarray(picks, np.int64)
    chunk, within = picks // B, picks % B
    draw = np.where(within < nb, within, within - nb)
    # every (chunk, draw) once, with the screens it yields
    pairs = np.unique(np.stack([chunk, draw], 1), axis=0)
    s_t = ar.t(np.sqrt(setup.powerspec).T * setup.freq.main.df)
    W = ar.t(setup.W, ar.cplx)
    pm_t = ar.t(setup.pm.T)
    mix = ar.t(mixing_matrix(N)) if noise == "mixed" else None
    scale = setup.dx ** 2 / setup.norm
    e = torch.arange(N * N, dtype=torch.int64, device=device)[None, :]
    per = max(1, _POINTS // (N * N))
    got = {}
    for lo in range(0, len(pairs), per):
        blk = pairs[lo:lo + per]
        ch = torch.as_tensor(blk[:, 0], device=device)[:, None]
        dr = torch.as_tensor(blk[:, 1], device=device)[:, None]
        b1, b2, _, _ = philox4x32_10(e, dr, ch, torch.zeros_like(ch), k0, k1)
        b1, b2 = b1.view(-1, N, N), b2.view(-1, N, N)
        if mix is not None:
            z1 = ar.mm(uniforms(b1).to(ar.real), mix)
            z2 = ar.mm(uniforms(b2).to(ar.real), mix)
        else:
            z1, z2 = (z.to(ar.real) for z in box_muller(b1, b2))
        X = torch.complex(z1 * s_t, z2 * s_t)
        H = ar.mm(W, ar.mm(X, W.T))
        c_re = _couplings(H.real, pm_t, scale).cpu().numpy()
        c_im = _couplings(H.imag, pm_t, scale).cpu().numpy()
        for i, (c, d) in enumerate(blk):
            got[(int(c), int(d))] = (c_re[i], c_im[i])
    chi = logamp_series(seed, setup).numpy()
    c = np.array([got[(int(i), int(d))][0 if w < nb else 1]
                  for i, d, w in zip(chunk, draw, within)])
    return setup.diffraction_limit * np.exp(2 * chi[picks]) * np.abs(c) ** 2


def ar_bits(k0, k1, step0, nsteps, L, N, device):
    """Philox words ``(b1, b2)`` (nsteps, L, N * N) of the AR noise of the
    absolute steps ``step0 ..`` (``step0`` even): one call a pair of
    steps, its words 0 and 1 the even step's, 2 and 3 the odd one's."""
    e = torch.arange(N * N, dtype=torch.int64, device=device)[None, None, :]
    lay = torch.arange(L, dtype=torch.int64, device=device)[None, :, None]
    pair = torch.arange(step0 // 2, (step0 + nsteps + 1) // 2,
                        dtype=torch.int64, device=device)[:, None, None]
    x0, x1, x2, x3 = philox4x32_10(e, lay, pair, torch.full_like(pair, 2),
                                   k0, k1)
    b1 = torch.stack([x0, x2], 1).flatten(0, 1)[:nsteps]
    b2 = torch.stack([x1, x3], 1).flatten(0, 1)[:nsteps]
    return b1, b2


def ar_powers(setup, seed, picks, noise="uniform", precision="float64",
              device="cpu"):
    """Power in watts of the steps ``picks`` (sorted, distinct) of an AR
    temporal run of seed ``seed``: the recursion ``a <- alpha e^{i phase}
    a + sqrt(1 - alpha^2) sqrt(PSD) df z`` from the initial state through
    every step up to the last pick, and at the picks the layer sum ``A``,
    the screen ``Re(W A W^T)`` and its couplings."""
    ar = Arith(precision, device)
    picks = np.asarray(picks, np.int64)
    nsteps = int(picks.max()) + 1
    want = np.zeros(nsteps, bool)
    want[picks] = True
    _, seed_scr = run_seeds(seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed_scr & 0xFFFF_FFFF_FFFF_FFFF)
    ps = np.asarray(setup.powerspec_per_layer, np.float64)
    L, N, _ = ps.shape
    df = setup.freq.main.df
    # the initial state: float32 normals, as the recipe draws them
    both = torch.randn((2, L, N, N), generator=g, dtype=torch.float32,
                       device=device)
    sqrt_psd_df = ar.t(np.sqrt(ps) * df)
    a = torch.complex(both[0].to(ar.real), both[1].to(ar.real)) * sqrt_psd_df
    k0, k1 = key(int(torch.randint(0, 2 ** 63 - 1, (), generator=g,
                                   device=device)))
    alpha = np.asarray(setup.alpha, np.float64)
    ph = ar.t(alpha[:, None, None] * np.exp(1j * setup.step_phase), ar.cplx)
    boiling = bool((alpha < 1).any())
    ns = ar.t(np.sqrt(np.maximum(0.0, 1 - alpha ** 2))[:, None, None]
              * np.sqrt(ps) * df)
    W = ar.t(setup.W, ar.cplx)
    pm = ar.t(setup.pm)
    scale = setup.dx ** 2 / setup.norm
    per = max(2, (_POINTS // (L * N * N)) // 2 * 2)
    out = []
    for s0 in range(0, nsteps, per):
        nt = min(per, nsteps - s0)
        if boiling:
            b1, b2 = ar_bits(k0, k1, s0, nt, L, N, device)
            if noise == "uniform":
                z1, z2 = uniforms(b1), uniforms(b2)
            else:
                z1, z2 = box_muller(b1, b2)
            nz = ns * torch.complex(z1.to(ar.real),
                                    z2.to(ar.real)).view(nt, L, N, N)
        A = []
        for t in range(nt):
            a = ph * a
            if boiling:
                a = a + nz[t]
            if want[s0 + t]:
                A.append(a.sum(0))
        if A:
            phs = ar.mm(W, ar.mm(torch.stack(A), W.T)).real
            out.append(_couplings(phs, pm, scale))
    c = torch.cat(out).cpu().numpy()
    chi = logamp_series(seed, setup).numpy()[picks]
    return setup.diffraction_limit * np.exp(2 * chi) * np.abs(c) ** 2
