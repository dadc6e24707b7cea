"""The least time of each kernel route, as the port's kernel bounds were
counted when the benchmark was defined: matrix-product FLOPs at the peak
of the run's ``PRECISION`` (one TF32 pass at 'default', fp32-accurate
3xTF32 otherwise), elementwise FLOPs at the card's fp32 rate, one after
the other, or the bytes at the memory rate, whichever takes longer.
Published peaks of one NVIDIA H100 SXM (dense, 700 W). ``P`` is the
pupil's own width in px, not the kernels' padded tile."""

PEAK_FP32 = 67e12          # FLOP/s outside the tensor cores
PEAK_TF32 = 495e12         # FLOP/s of one TF32 pass
PEAK_MMA = PEAK_TF32 / 3   # FLOP/s of fp32-accurate (3xTF32) products
PEAK_BYTES = 3.35e12       # B/s

#: The product peak of each ``PRECISION``.
PEAKS = {"default": PEAK_TF32, "high": PEAK_MMA, "highest": PEAK_MMA}


def _bound(flops, nbytes, elementwise=0, peak=PEAK_MMA):
    """(ms, what bounds it, FLOPs): matrix-product FLOPs at ``peak`` and
    elementwise ones at PEAK_FP32, one after the other, or the bytes at
    PEAK_BYTES, whichever takes longer."""
    t_ops = flops / peak + elementwise / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            flops + elementwise)


def k2_bound(N, P, nbatch, mixed, peak=PEAK_MMA):
    """K2's least time in ms for ``nbatch`` draws at an (N, N) grid and a
    P px pupil: 4N^3 mixing FLOPs ('mixed'), 8N^2 P for G' and 8P^2 N for
    H per draw; or its tables in and sums out at the memory rate."""
    flops = nbatch * ((4 * N ** 3 if mixed else 0) + 8 * N * N * P
                      + 8 * P * P * N)
    nbytes = 4 * (N * N * (2 if mixed else 1) + 2 * P * N + P * P
                  + 4 * nbatch)
    return _bound(flops, nbytes, peak=peak)


def k1_bound(N, P, nbatch, mixed, peak=PEAK_MMA):
    """K1's least time in ms: per draw and column a (1 x K) @ (K x 2P)
    factor product (K = 2 * 128 noise rows for 'mixed', 2P for 'gauss')
    and 8P^2 N for the column contraction; or its factor table, W and pm
    in and sums out at the memory rate."""
    K = 2 * (128 if mixed else P)
    flops = nbatch * (N * 2 * K * 2 * P + 8 * P * P * N)
    nbytes = 4 * (N * K * 2 * P + 2 * P * N + P * P + 4 * nbatch)
    return _bound(flops, nbytes, peak=peak)


def k3_bound(N, P, nbatch, mixed, peak=PEAK_MMA):
    """K3's least time in ms: per draw and column the complex (1 x Kq) @
    (Kq x P) factor product as four real ones (Kq = the pupil rounded up
    to 128 lanes for 'mixed', P for 'gauss') and 8P^2 N for the column
    contraction; or its factor table, W and pm in and sums out at the
    memory rate."""
    Kq = -(-P // 128) * 128 if mixed else P
    flops = nbatch * (N * 2 * Kq * 2 * P * 2 + 8 * P * P * N)
    nbytes = 4 * (N * Kq * 2 * P + 2 * P * N + P * P + 4 * nbatch)
    return _bound(flops, nbytes, peak=peak)


def ar_bound(L, N, P, nsteps, boiling, nseries=1, peak=PEAK_MMA):
    """K4's, K5's and (for ``nseries`` series) K6's least time in ms for
    ``nsteps`` steps of L layers at an (N, N) grid and a P px pupil: per
    step and series 8PN^2 FLOPs for G' and 4P^2 N for the real screen,
    plus 8LN^2 elementwise in the recurrence and layer sum and 8LN^2 more
    with boiling; or states, phasors, noise scales and pupil modes in (W
    once), states and couplings out at the memory rate."""
    flops = nseries * nsteps * (8 * P * N * N + 4 * P * P * N)
    elementwise = nseries * nsteps * (16 if boiling else 8) * L * N * N
    nbytes = 4 * (nseries * ((7 if boiling else 6) * L * N * N + P * P
                             + 2 * nsteps) + 2 * P * N)
    return _bound(flops, nbytes, elementwise, peak)


def iid_least_ms(N, P, ndraws, mixed, precision):
    """The least time in ms of ``ndraws`` iid draws over the port's float32
    iid routes: the pruned-DFT route (K2's count) and the column-factor
    route (K1's count up to a 128 px pupil, K3's above), whichever is
    less, whatever route the run took."""
    peak = PEAKS[precision]
    colfac = k1_bound if P <= 128 else k3_bound
    return min(k2_bound(N, P, ndraws, mixed, peak)[0],
               colfac(N, P, ndraws, mixed, peak)[0])
