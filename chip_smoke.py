"""Smoke run of fast_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
   fails without a CUDA device;
2. build the synth-detect and synth-screens kernels K2 and K7
   (``csrc/synth_detect.cu``), the colfac-detect kernels K1
   (``csrc/colfac_detect.cu``) and K3 (``csrc/colfac_split.cu``) and the AR
   flow kernels K4, K5 and K6 (``csrc/ar_flow.cu``), one ``nvcc`` each, started
   together; print ptxas registers, spills and shared memory of each pass
   at the flagships' padded pupil (P=96) and at the 4 m link's (P=416:
   pass 1 of K2, K7 and K3, the second pass of K1, K2, K3 and K7 and the
   AR kernels' two products in two slices of 208 px), and of the AR update
   at 4 layers a thread and at the streamed kernel's default block;
3. K2 against its plain torch version on the card, 'mixed' and 'gauss'
   noise, from the same Philox bits: at the 256^2 flagship shapes (N=256,
   P=82) over 4100 draws, which takes two launches, the second from draw
   4096; and at the default config's (N=102, P=102). Then the same
   comparison with the plain version's products at TF32, a
   lower-precision control that the limit must reject; pass 1 alone
   (``fast_synth_pass1``, 3xTF32 ``wgmma`` on the tensor cores) timed with the
   FLOP/s of its products beside its yardsticks (one ``torch.matmul`` of
   the mixing product and one complex64 ``torch.matmul`` of G' = X' W^T,
   TF32 off), and K2's detect pass alone (``detect_pass``, H^T = G'^T W^T
   in 3xTF32 ``wgmma``, the draws stacked along its 64 rows, from the laid
   W table) beside one complex64 ``torch.matmul`` of W @ G'; K2 with
   subharmonic screens over
   4100 draws; and the device sincos against float64;
4. K1 against its plain version at the 512^2 flagship shapes (N=512,
   P=82), 'mixed' and 'gauss', over 4100 draws (two launches), the kernel
   on the engine's table (split and laid out once for its pass 1), the
   plain version on the unsplit one, with the TF32 control; its two passes
   alone ('mixed': pass 1, ``colfac_pass1``, 3xTF32 ``wgmma``, and the
   detect pass, ``detect_pass``, 3xTF32 ``wgmma``) timed with their
   FLOP/s over the pupil's px and their bounds, beside their yardsticks:
   one batched ``torch.bmm`` of pass 1's (draws x K) @ (K x 2P) per column
   and one complex64 ``torch.matmul`` of W @ G' (TF32 off);
5. the 256^2 slice: ``Fast(flagship(), device="cuda").run()`` at
   NITER=262144, NCHUNKS=16, which must go through K2 (launch count) and
   agree in distribution with the plain SYNTH='matmul' path on the same
   card; then the default config, NITER=65536, through K2 and 'matmul';
6. the 512^2 slice: ``Fast(flagship(NPXLS=512), device="cuda")``, where
   SYNTH='auto' must pick K1; its run at NITER=262144 must launch K1 and
   not K2, and agree with 'matmul' (NCHUNKS=64, for memory);
7. subharmonics: SUBHARM=True at 256^2 through K2 and at 512^2
   (NITER=65536) through K1, each against 'matmul' with SUBHARM=True;
8. K4 (``ar_flow_fused``) against its plain version at the temporal
   flagship's shapes (N=256, 4 layers, P=82) from the same initial state
   and the same Philox bits: pure frozen flow, 'uniform' and 'gauss'
   boiling, over 4100 steps (two launches: the carried state and the
   absolute-step counter), the final state bit for bit and the couplings
   within the limit, with the TF32 control; a K4 series cut into two calls
   at an odd step against one call (the pairs of steps that share a
   Philox call), bit for bit; K5 (``ar_flow_streamed``) the
   same on the 16-layer 512^2 link over 260 steps in launches of 256, and
   K5 against K4 on the 4-layer flagship; each AR kernel's passes
   (``ar_update``, ``ar_dft``, ``ar_detect``) timed alone from one
   profiled launch (here K4 and K5, K6 in 12, K4 at 402 px in 13);
9. the temporal slice: ``Fast(flagship(TEMPORAL=True, TEMPORAL_SYNTH='ar',
   DT=0.001, NITER=65536, NCHUNKS=16), device="cuda").run()`` must launch
   K4 and no other kernel, return finite power with a lag-1
   autocorrelation over 0.9, and agree in its marginal with the iid
   'matmul' run (mean within 5 standard errors at the series' effective
   sample count, KS test on the series thinned beyond its integrated
   autocorrelation time); the 16-layer 512^2 link through K5 at
   NITER=8192; the 'ar' kernel route against the SYNTH='fft' route from
   one seed; one 'screens' run;
10. the wide-pupil slice, the 1024^2 link with a 4 m telescope
   (``flagship(NPXLS=1024, D_GROUND=4.0, DSUBAP=0.5)``: a 402 px pupil,
   padded to 416): K2 ('mixed', 'gauss', 'mixed' with subharmonic
   screens), K3 ('mixed', 'gauss') and K7 against their plain versions from
   identical Philox bits over 640 draws, which take two launches of at
   most 630 (2 GiB of G' scratch), with the TF32 control; the stock-op
   detector on K7's screens against K2 'gauss'; the same three kernels at
   a 144 px pupil on a 192^2 grid (two tiles of 80 px an axis, the second
   ragged); then ``Fast(...).run()`` through 'auto' (K2, NITER=16384),
   pinned 'pallas_colfac' (K3, 8192) and 'pallas' (K7, 8192), each of
   which must launch its kernel and no other and agree with a 'matmul' run
   (4096); times per 630-draw launch beside bounds and plain versions,
   pass 1 alone for K2 ('mixed') and K7 (Box-Muller), K2's detect pass
   alone beside one complex64 ``torch.matmul`` of W @ G', K7's screens pass
   alone (``screens_pass``, the same product on ``wgmma``, the screens
   written out) on K7's G', held element by element against its plain
   version (2N 2^-24 max |phi|) and timed beside the same yardstick, K3's
   two
   passes alone with their yardsticks (as K1's in 4), warm rates and one
   profile per path;
11. times: each kernel's ms per 4096 draws or steps beside its bound and
   its plain version's; the factor build at 512^2; warm ``run()`` rates at
   256^2 (K2, 'matmul', K2 'gauss', K1 pinned), at 512^2 (K1, 'colfac',
   'matmul' and K2 pinned at fewer realizations) and of the temporal
   routes (K4, 'fft', K5); then one warm run of the K2, K1, 'colfac',
   'matmul', K4 and K5 paths under ``torch.profiler``;
12. the orbit passes, each with every kernel's count at 0 first: the iid
   pass of ``bench.py``'s ``measure_orbit_pass`` (16 samples of a 600 km
   pass, 65,536 realizations each, NCHUNKS=4, at the 256^2 flagship)
   through ``build_sweep`` and ``run_scan_sharded`` on a (1, 1) mesh, which
   must launch K2 and no other kernel and agree per sample with the same
   pass on 'matmul' (mean within 5 combined standard errors, scintillation
   index within 5% or 5 combined standard errors where wider); then the
   temporal pass with ``examples/orbit_temporal_scan.py``'s geometry (16
   samples of a 550 km pass at the temporal flagship, 16,384 steps each)
   through ``FAST_sat_orbit_from_geometry`` and ``run_orbit_sweep``, which
   must launch K6 and no other kernel and give finite series;
   ``run(progress=True)`` against ``run()``, bit for bit; 4 samples (the
   pass's samples 0, 5, 10 and 15) x 4,096 steps of the K6 route against
   the scan's SYNTH='fft' route (the first 1,024 steps within 2e-3), and
   the pass's lag-1 autocorrelations within 0.05 of that exact route's
   there and over its least less 0.05 everywhere (the pass's slew moves
   the upper layers 15-30 px a step); K6 against its plain version
   ('uniform' and 'gauss', final states bit for bit, each with the TF32
   control): at the pass's own shape (all 16 series, 512 steps in two
   launches) and on four of its series for 1,024 steps; K6 with one
   series against K4; K6's time per
   256 steps of the 16 series; one K6 scan against 16 serial ``run()``
   calls through K4; end-to-end rates, the sweep or the ``Fast()`` inits
   inside the wall;
13. the AR kernels past 128 px: K6 and its plain version against a
   float64 numpy evaluation on inputs of the 64^2 amplitudes (screens of
   tens of radians) at 144 px (two tiles) and 112 px (one tile) on a
   192^2 grid and at 402 px on a 1024^2 grid, where the kernel's error
   may not exceed 10 times the plain version's; K4, K5 and K6 against
   their plain versions
   at a 144 px pupil on a 192^2 grid and at the 1024^2 link's 402 px
   pupil, times per 256 steps there, and the wide link's temporal run
   (``Fast(temporal(NPXLS=1024, D_GROUND=4.0, DSUBAP=0.5))``, 2,048 steps)
   through K4;
14. the AR kernels' two products alone, on the laid W table, at the
   (step, series) pairs of one tile at 256^2 (K4's and K6's), 512^2 (K5's)
   and 1024^2 with the 402 px pupil: the first DFT product (``ar_dft``,
   the second pass of ``csrc/detect.cuh``, 3xTF32 ``wgmma``) with G'
   against its plain version element by element within N 2^-24 max |G'|,
   with the TF32 control, and the real-only detect (``ar_detect``, the
   same pass with two row groups a block of work) against its plain
   version within the limit on the same G'; each time and FLOP/s beside
   its bound, its plain version and its yardstick, the pass's library
   time (one complex64 ``torch.matmul`` of G', the two real
   ``torch.matmul`` of Re(W G'); TF32 off);
15. the FSO comms layer: ``FastFSOC(flagship(COHERENT=True,
   MODULATION='16-QAM', EsN0=14))`` at NITER=262144 with 1000 symbols an
   iteration, which must launch K2 and no other kernel, its modem on the
   card, and give an SEP within 5 standard errors (over iterations) of the
   fading-averaged ``sep_qam`` on the same normalised power; its r/s
   (first and warm run), the modem's symbols/s and the peak memory; the
   I-Q PDFs of its field
   (M=16, 64^2 bins: 'individual', 'full', 'full' with shot noise) and
   GMI and MI on the card (float32) against the CPU port (float64), GMI and
   MI within 1e-3 bit/symbol; then ``fade_prob``, ``fade_dur`` and the
   1e-3 and 1e-4 quantiles of I/<I> on the temporal flagship's 65,536-step
   K4 series (the last warm run of 9 and 11) at 0.5 and 0.2 of the mean,
   on the card and on a CPU copy, whose fade counts must be equal;
16. the multi-device layer (``parallel``), each path with every count at
   0 first: (a) ``make_mesh()``, an NCCL world of one rank on the card in
   this process: ``run_sharded`` of the 256^2 flagship (K2, 32 launches)
   and of the 512^2 flagship (K1) bit for bit ``run()``, warm r/s beside
   the serial run's, ``sharded_moments`` of the series against numpy
   float64 (1e-12), the temporal flagship with TEMPORAL_ALPHA=1 (65,536
   steps, K4) and a 16-layer one (4,096 steps, K5) bit for bit ``run()``,
   the boiling temporal flagship (8,192
   steps) layer-sharded against the serial SYNTH='fft' route (2e-3); then
   (b) two gloo ranks sharing the card, spawned by the dryrun twin
   (``parallel.dryrun``), each reporting its own launches: the flagship at
   NCHUNKS 8 bit for bit the serial run at 16 (K2), the alpha = 1 windows
   (K4) within 2 x offset x 2^-24 x phi_rms of the mean power of the
   serial series, the layer-sharded boiling series against 'fft' (2e-3),
   a (2, 1) AR scan of the temporal orbit pass's 16 samples at 4,096 steps
   (K6, 8 series a rank) and a (1, 2) iid scan of 4 of the iid pass's
   samples (K2) bit for bit their (1, 1) scans; every rank holds the same
   series; the ranks' warm flagship rate against the serial run's;
17. the tooling (``phase_tools``): (a) the dossier twin
   (``scripts/torch_validate_hw.py``) in this process at its --quick sizes,
   every section but the 1024^2 fade panel, which must pass every row and
   launch each of the seven kernels; (b) ``utils.profiling.trace`` around
   one warm 256^2 K2 run inside an ``annotate`` region, whose trace file
   must name the region and K2's two passes; (c) the factor tables' disk
   cache at 1024^2 with the 4 m pupil in a temporary directory: the card's
   float32 init, which must build its factors and cache nothing, with the
   save and load of its stack timed alone; the host's float64 build of a
   float64 ``'colfac'`` run: an init that saves, one that loads, the
   loaded L and its ``run()`` bit for bit the saving init's; (d) the seven
   example twins (``examples/torch_*.py``) at their written sizes, started
   together, each of which must exit 0 and print its JAX example's column
   headers. Every other phase runs with ``FAST_TPU_TABLE_CACHE=0``;
18. ``PRECISION`` (``phase_precision``, run after 14 and before 15: the
   profiler sessions of 16 and 17 leave it without device records): the
   config's default,
   'default', runs every kernel product in one TF32 pass (the main paths
   of the phases above: each slice, wide, temporal and orbit run checks
   that every kernel it launched was its one-pass instantiation, by the
   wrappers' ``LAUNCHES_BY_PASSES``; the kernel-against-plain checks
   above call the wrappers at their default, 'highest', 3xTF32, with the
   limits they had); then each kernel at 'default' against its plain
   version at 'default', pass by pass on the same inputs (pass 1, the
   detect pass or K7's screens pass on that pass's own G', the AR
   kernels' two products on the same layer sums and G'; K2 and K1 at the
   flagships' shapes, K3, K7 and K2 at the 4 m link's): a pass on the
   same float32 operands within its 3xTF32 limit, a pass or a kernel on
   float32 work done otherwise (pass 1 of K2 and K7, Box-Muller noise,
   the kernels whole) within ``ONE_PASS_MAX`` and ``ONE_PASS_RMS`` of
   the TF32 distance |plain('default') - plain('highest')|
   (``tests/test_torch_tf32x3.py``), K4, K5 and K6 with their final
   states bit for bit; each kernel timed at 'highest' and 'default' in
   turns beside its one-pass bound; last each main path's series at
   'default' (256^2 K2, 512^2 K1, 1024^2 K3 and K7, the temporal K4 and
   K5 series) against a run at 'highest' from another seed, which must
   launch only 3xTF32 instantiations: iid as the slices against 'matmul'
   and a KS test (p > 1e-3), temporal at the effective sample count and
   KS on the thinned series. Each kernel's entry gains ``default``.

The last lines are the card, one JSON object of per-kernel numbers (each
with its launches on the mesh phase, ``launches_mesh``: (a)'s and each of
(b)'s ranks; then the comms, mesh and tools phases' numbers and each main
path's launches by TF32 passes) and one of the run's device. The flagship
config is the AO-corrected 0.8 m uplink at 1550 nm through a 4-layer HV57/Bufton profile, at DX=0.01 m:
a 256^2 grid (``__graft_entry__.py``) and the same link at 512^2; the
temporal mode runs it at DT = 1 ms, and through a 16-layer profile at
512^2; the wide-pupil link is the same uplink from a 4 m telescope with
0.5 m subapertures on a 1024^2 grid (``bench.py``'s large-telescope
configuration).
"""

import glob
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

NITER = 262144
NCHUNKS = 16
NITER_SMALL = 65536   # realizations of the slower or secondary runs
NITER_K2_512 = 32768  # K2 pinned at 512^2, the slowest yardstick
NSTEPS = 4100         # steps of a K4-against-plain check: two launches of
                      # at most 4096 steps
NSTEPS_K5 = 260       # steps of a K5 check at 16 layers x 512^2, in
MAX_STEPS_K5 = 256    # launches of at most 256 steps (its plain version
                      # draws 4.2 M Philox words per step)
NITER_T = 65536       # steps of the temporal slice (NCHUNKS=16)
NITER_T16 = 8192      # steps of the 16-layer 512^2 temporal run
NITER_FFT = 8192      # steps of the timed SYNTH='fft' temporal run
ACF_MIN = 0.9         # lag-1 autocorrelation of a temporal power series
ACF_ORBIT_TOL = 0.05  # the temporal orbit pass's lag-1 autocorrelations
                      # against the exact route's on the same geometry: its
                      # slew (ANISO_DL) moves the upper layers 15-30 px a
                      # step, so 0.9 does not hold there
KS_PVALUE = 1e-3      # thinned temporal series against the iid draws
FFT_RTOL = 2e-3       # 'ar' kernel route against the SYNTH='fft' route
NDRAWS = 4100         # complex draws of a kernel-against-plain check: two
                      # launches of at most 4096 draws
NTIME = 4096          # complex draws of a timed call: one launch
KERNEL_REL = 4e-6     # kernel vs plain, times the largest |sum|: fp32
                      # products and sums in another order differ by a few
                      # ulp of the sums; TF32 products differ by far more
MEAN_SIGMAS = 5.0     # kernel path vs plain path, combined standard errors
SI_REL = 0.05         # scintillation index, relative
SEED = 0x5EED_1234_ABCD
DEVICE = "cuda"
PJ = 6                # the flagships' pupil, 82 px, padded to 16 * PJ = 96
WIDE = dict(NPXLS=1024, D_GROUND=4.0, DSUBAP=0.5)  # the wide-pupil link
WIDE_SHAPE = (1024, 402)  # its grid side and pupil width
NITER_W = 16384       # its realizations through 'auto' (K2), NCHUNKS=4
NITER_W_SMALL = 8192  # through K3 and K7
NITER_W_MATMUL = 4096  # through 'matmul', whose noise is 8.4 MB a draw
NDRAWS_W = 640        # draws of a wide kernel check: two launches, since
                      # 2 GiB of G' scratch hold 630 draws at N=1024, P=416
NSAMP = 16            # samples of an orbit pass
NITER_OI = 65536      # realizations a sample of the iid orbit pass (NCHUNKS=4)
NITER_OT = 16384      # steps a sample of the temporal orbit pass (NCHUNKS=4)
NSTEPS_K6 = 1024      # steps of a K6-against-plain check on 4 series
NSTEPS_K6_MAIN = 512  # steps of the check at the pass's own shape (16
MAX_STEPS_K6 = 256    # series, 16-step tiles), in two launches
NITER_OT_FFT = 4096   # steps a sample of the 4-sample pass through K6 and
                      # through the scan's SYNTH='fft' route
AMP_64 = (0.02, 0.01)  # per-mode state and noise scale of the 64^2 inputs
ROUNDOFF_RATIO = 10.0  # kernel's error against float64 over the plain
                       # version's: round-off keeps the two of one size
NITER_WT = 2048       # steps of the wide link's temporal run (NCHUNKS=2)
SI_SIGMAS = 5.0       # scintillation index of a short run: combined
                      # standard errors from 16 blocks, where that is wider
                      # than SI_REL
COMMS = dict(MODULATION="16-QAM", EsN0=14)  # the FSO comms run's modem
COMMS_M, COMMS_ESN0 = 16, 14
COMMS_NPXLS = 64      # I-Q bins a side of the PDFs
SEP_SIGMAS = 5.0      # modem SEP against the fading-averaged closed form,
                      # standard errors over iterations
MI_TOL = 1e-3         # GMI and MI, card (float32) against CPU (float64),
                      # bit/symbol
FADE_THRESHOLDS = (0.5, 0.2)   # of the mean power
FADE_QUANTILES = (1e-3, 1e-4)  # of I / <I>
MESH_RANKS = 2        # gloo ranks sharing the card in the mesh phase's (b)
NITER_BOIL = 8192     # steps of the layer-sharded boiling series (NCHUNKS=16)
NITER_SCAN_T = 4096   # steps a sample of the (2, 1) AR scan (NCHUNKS=4)
NSAMP_IID_SCAN = 4    # samples of the (1, 2) iid scan (0, 5, 10, 15)
MOMENTS_REL = 1e-12   # sharded_moments against numpy float64, relative
NITER_CACHE = 1260    # realizations of the disk-cache phase's float32 init at
                      # 1024^2 (K3: two launches of 630)
NITER_CACHE_64 = 64   # realizations of each of its float64 runs
EXAMPLE_TIMEOUT = 300  # seconds for the seven example twins, run together
# each example twin and the column headers of its JAX example it must print
EXAMPLES = {
    "link_budget_study": ["zenith", "mean dBm", "scint idx", "1% fade dB",
                          "r0_los cm"],
    "long_temporal_ar": ["AR mode-survival alpha per layer", "steps/s",
                         "fade probability below 0.5*mean",
                         "mean fade duration"],
    "modem_gmi_study": ["SEP(meas)", "BER(analytic)", "GMI [bit/sym]",
                        "16-QAM"],
    "orbit_sweep": ["t [s]", "elev", "range km", 'PAA "', "mean dBm",
                    "scint"],
    "orbit_temporal_scan": ["P(fade<-3dB)", "mean fade dur[ms]"],
    "temporal_series": ["fade probability (<80% mean)",
                        "intensity correlation time (1/e)"],
    "example_config": ["FAST result statistics"],
}
REPO = os.path.dirname(os.path.abspath(__file__))
# a window of an alpha = 1 series starts from the exact phasor power; the
# serial route multiplies the float32 phasor, off by up to ~2^-24 a step,
# `offset` times: |d state| / |state| ~ offset 2^-24 per mode, so |d phi|
# ~ offset 2^-24 phi_rms and |d I| / <I> ~ 2 offset 2^-24 phi_rms (the
# plain version on the CPU reads 0.12-0.20 of offset 2^-24 phi_rms in |c|
# at 64^2 and 256^2, offsets 1024-8192)
AR_JUMP_FACTOR = 2.0
# the H100 SXM's published rates (NVIDIA data sheet, at 700 W): float32
# outside the tensor cores; matrix products at fp32 accuracy on the tensor
# cores, three TF32 passes (3xTF32) at 495 TFLOP/s; device memory
PEAK_FP32 = 67e12          # FLOP/s
PEAK_MMA = 495e12 / 3      # FLOP/s of fp32-accurate matrix products
PEAK_TF32 = 495e12         # FLOP/s of one TF32 pass (PRECISION='default')
PEAK_BYTES = 3.35e12       # B/s
# a kernel at PRECISION='default' (one TF32 pass) against its plain version
# at 'default' (tests/test_torch_tf32x3.py states both limits): a pass whose
# float32 operands are the plain version's bit for bit keeps the 3xTF32
# limits (KERNEL_REL, GPRIME_REL, 2N 2^-24 max |phi|); one whose operands
# come out of float32 work done otherwise (pass 1 of K2 and K7, Box-Muller
# noise, a whole kernel's second product on its own G') is held in units
# of the TF32 distance |plain('default') - plain('highest')|: its max and
# its rms
ONE_PASS_MAX = 1.0
ONE_PASS_RMS = 0.25
# the precision phase's shapes: (N, pupil rows lo..hi) of K2 and K1 (with
# the draws of a check), of the 4 m link's kernels (draws of a check, of a
# timed launch), of the AR products ((step, series) pairs) and of K4, K5
# and K6 whole ((N, lo, hi, layers, series), steps of a check, timed)
PREC_IID = ((256, 87, 169), (512, 215, 297))
PREC_IID_DRAWS = 64
PREC_WIDE = (1024, 311, 713, 16, 630)
PREC_AR_PRODUCTS = ((256, 87, 169, 1024, ("K4", "K6")),
                    (512, 215, 297, 256, ("K5",)),
                    (1024, 311, 713, 64, ("K4",)))
PREC_AR_WHOLE = (("K4", (256, 87, 169, 4, 1), 300, NTIME),
                 ("K5", (512, 215, 297, 16, 1), 64, 256),
                 ("K6", (256, 87, 169, 4, NSAMP), 64, 256))
# the main paths' series at the config's PRECISION ('default'), by kernel,
# for the precision phase's checks in distribution against 'highest'
SERIES = {}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def flagship(nlayers=4, **overrides):
    from fast_tpu_torch import conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(nlayers)
    p = dict(conf.DEFAULTS)
    p.update({
        "NPXLS": 256, "DX": 0.01, "NITER": NITER, "NCHUNKS": NCHUNKS,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.arange(nlayers) * (360.0 / nlayers),
        "SEED": 1, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def temporal(nlayers=4, **overrides):
    """The flagship link as a time series at DT = 1 ms on the AR route."""
    kw = dict(TEMPORAL=True, TEMPORAL_SYNTH="ar", DT=0.001, NITER=NITER_T,
              NCHUNKS=16)
    kw.update(overrides)
    return flagship(nlayers, **kw)


def default_config(**overrides):
    from fast_tpu_torch import conf
    p = dict(conf.DEFAULTS)
    p.update({"NITER": NITER_SMALL, "NCHUNKS": 4, "SEED": 2,
              "LOGLEVEL": "WARNING"})
    p.update(overrides)
    return p


def cuda_ms(fn, reps, warm=True):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after one
    more to warm up unless the caller has run it before."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed(fn):
    """(fn(), host seconds), the clock closed by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_run(sim):
    return timed(sim.run)


def launches_of(fn, counter):
    """Run ``fn()`` with ``counter.LAUNCHES`` set to 0 first; returns
    ``(fn(), launches)``."""
    counter.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, counter.LAUNCHES


def by_passes():
    """Every kernel's launches so far by pass count, {K1..K7: {1: n, 3:
    n}}: the wrappers' ``LAUNCHES_BY_PASSES``."""
    from fast_tpu_torch.ops import kernel_wrappers
    return {k: dict(w.LAUNCHES_BY_PASSES)
            for k, w in kernel_wrappers().items()}


# each main path's launches by pass count, {label: {kernel: (one, three)}}
MAIN_PASSES = {}


def check_passes(before, precision, label):
    """The launches of every kernel since ``before`` (:func:`by_passes`),
    which must all be of the TF32 pass count of ``precision`` (one at
    'default', three at 'high' and 'highest'); prints and keeps them
    (``MAIN_PASSES``)."""
    from fast_tpu_torch.ops.synth_detect import passes
    want = passes(precision)
    now = by_passes()
    delta = {k: tuple(now[k][n] - before[k][n] for n in (1, 3)) for k in now}
    ran = {k: v for k, v in delta.items() if any(v)}
    print(f"{label}: PRECISION={precision!r}, launches by TF32 passes (one, "
          f"three): " + (", ".join(f"{k} {v}" for k, v in ran.items())
                         or "none"))
    if any(v[0 if want == 3 else 1] for v in ran.values()):
        fail(f"{label}: a kernel launched at another pass count than "
             f"PRECISION={precision!r}'s {want}")
    MAIN_PASSES[label] = ran
    return ran


def k2_bound(N, P, nbatch, mixed, peak=PEAK_MMA):
    """K2's least time in ms for ``nbatch`` draws at an (N, N) grid and a
    P px pupil: 4N^3 mixing FLOPs ('mixed'), 8N^2 P for G' and 8P^2 N for
    H per draw, matrix products at the fp32-accurate tensor-core rate, or
    its tables in and sums out at the memory rate, whichever is longer."""
    flops = nbatch * ((4 * N ** 3 if mixed else 0) + 8 * N * N * P
                      + 8 * P * P * N)
    nbytes = 4 * (N * N * (2 if mixed else 1) + 2 * P * N + P * P
                  + 4 * nbatch)
    return _bound(flops, nbytes, peak=peak)


def k1_bound(N, P, nbatch, mixed, peak=PEAK_MMA):
    """K1's least time in ms: per draw and column a (1 x K) @ (K x 2P)
    factor product (K = 2 * 128 noise rows for 'mixed', 2P for 'gauss')
    and 8P^2 N for the column contraction, matrix products at the
    fp32-accurate tensor-core rate; or its factor table, W and pm in and
    sums out at the memory rate."""
    K = 2 * (128 if mixed else P)
    flops = nbatch * (N * 2 * K * 2 * P + 8 * P * P * N)
    nbytes = 4 * (N * K * 2 * P + 2 * P * N + P * P + 4 * nbatch)
    return _bound(flops, nbytes, peak=peak)


def k3_bound(N, P, nbatch, mixed, peak=PEAK_MMA):
    """K3's least time in ms: per draw and column the complex (1 x Kq) @
    (Kq x P) factor product as four real ones (Kq = the pupil rounded up
    to 128 lanes for 'mixed', P for 'gauss') and 8P^2 N for the column
    contraction, matrix products at the fp32-accurate tensor-core rate;
    or its factor table, W and pm in and sums out at the memory rate."""
    Kq = -(-P // 128) * 128 if mixed else P
    flops = nbatch * (N * 2 * Kq * 2 * P * 2 + 8 * P * P * N)
    nbytes = 4 * (N * Kq * 2 * P + 2 * P * N + P * P + 4 * nbatch)
    return _bound(flops, nbytes, peak=peak)


def k7_bound(N, P, nbatch, peak=PEAK_MMA):
    """K7's least time in ms: K2's count with Box-Muller noise, 8N^2 P for
    G' and 8P^2 N for the screens per draw, matrix products at the
    fp32-accurate tensor-core rate; or sqrt(PSD) and W in and two P x P
    screens out per draw at the memory rate."""
    flops = nbatch * (8 * N * N * P + 8 * P * P * N)
    nbytes = 4 * (N * N + 2 * P * N + 2 * P * P * nbatch)
    return _bound(flops, nbytes, peak=peak)


def ar_bound(L, N, P, nsteps, boiling, nseries=1, peak=PEAK_MMA):
    """K4's, K5's and (for ``nseries`` series) K6's least time in ms for
    ``nsteps`` steps of L layers at an (N, N) grid and a P px pupil: per
    step and series 8PN^2 FLOPs for G' and 4P^2 N for the real screen,
    matrix products at the fp32-accurate tensor-core rate, plus 8LN^2 in
    the recurrence and layer sum and 8LN^2 more with boiling (the noise's
    scale and its scaled add), elementwise at the fp32 rate; or states,
    phasors, noise scales and pupil modes in (W once), states and
    couplings out at the memory rate."""
    flops = nseries * nsteps * (8 * P * N * N + 4 * P * P * N)
    elementwise = nseries * nsteps * (16 if boiling else 8) * L * N * N
    nbytes = 4 * (nseries * ((7 if boiling else 6) * L * N * N + P * P
                             + 2 * nsteps) + 2 * P * N)
    return _bound(flops, nbytes, elementwise, peak)


def _bound(flops, nbytes, elementwise=0, peak=PEAK_MMA):
    """(ms, what bounds it, FLOPs): matrix-product FLOPs at ``peak``
    (PEAK_MMA, fp32-accurate; PEAK_TF32 for one TF32 pass) and elementwise
    ones at PEAK_FP32, one after the other, or the bytes at PEAK_BYTES,
    whichever takes longer."""
    t_ops = flops / peak + elementwise / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            flops + elementwise)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    # full fp32 in every plain matrix product (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# a kernel's name and template arguments in its mangled entry name
_ENTRY = re.compile(r"(synth_pass1|colfac_pass1|split_pass1|detect_pass|"
                    r"screens_pass|ar_update|ar_dft|ar_detect)"
                    r"I((?:L[bi]\d+E)+)E")


def _describe(name, a):
    """What one compiled pass is, or None for those not printed: the
    passes at the flagships' padded pupil (P=96, one W slice) and at the 4
    m link's (P=416 in two slices of 208 px), each at one TF32 pass and at
    three (the last template argument), and the AR update at 4 layers a
    thread and at the streamed kernel's default block."""
    what = _describe_shape(name, a)
    if what and name != "ar_update":
        what += f", {a[-1]} TF32 pass{'es' if a[-1] > 1 else ''}"
    return what


def _describe_shape(name, a):
    noise = ("gauss", "mixed")
    if name == "synth_pass1" and 64 * a[2] + a[3] in (16 * PJ, 208):
        pb = 64 * a[2] + a[3]
        return (f"P={16 * PJ if pb == 16 * PJ else 416} {noise[a[0]]} "
                f"slices of {pb} px" + (" in pairs" if a[1] else ""))
    if name == "colfac_pass1" and a[1] == PJ:
        return f"P={16 * PJ} {noise[a[0]]}"
    if name == "split_pass1" and 64 * a[1] + a[2] == 208:
        return f"P=416 {noise[a[0]]} slices of 208 px in clusters of two"
    if name in ("detect_pass", "screens_pass") and 64 * a[0] + a[1] in (
            16 * PJ, 208):
        pb = 64 * a[0] + a[1]
        return (f"P={pb}" if pb == 16 * PJ else "P=416 slices of 208 px")
    from fast_tpu_torch.ops.ar_flow import STREAM_LAYERS
    if name == "ar_update" and a[0] in (4, STREAM_LAYERS):
        return f"{a[0]} layers " + ("frozen", "uniform", "gauss")[a[1]]
    if name in ("ar_dft", "ar_detect") and 64 * a[0] + a[1] in (16 * PJ,
                                                                 208):
        pb = 64 * a[0] + a[1]
        return (f"P={pb}" if pb == 16 * PJ else "P=416 slices of 208 px")
    return None


LIBRARIES = ["synth_detect", "colfac_detect", "colfac_split", "ar_flow"]


def phase_build():
    from fast_tpu_torch.ops import _build
    t0 = time.perf_counter()
    infos = _build.build_all(LIBRARIES)
    print(f"build: {len(infos)} libraries in {time.perf_counter() - t0:.1f} "
          f"s (" + ", ".join(f"{k}.cu nvcc {v.seconds:.1f} s"
                             for k, v in infos.items()) + ")")
    for name, info in infos.items():
        what = None
        serial = sorted({e.group(1) + "<" + ", ".join(re.findall(
            r"L[bi](\d+)E", e.group(2))) + ">"
            for e in (_ENTRY.search(ln) for ln in info.log.splitlines()
                      if "C7511" in ln) if e})
        print(f"  ptxas {name}: wgmma serialized (C7511) in "
              + (", ".join(serial) or "none"))
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                e = _ENTRY.search(m.group(1))
                what = e and _describe(
                    e.group(1), [int(v) for v in
                                 re.findall(r"L[bi](\d+)E", e.group(2))])
                what = what and f"{e.group(1)} {what}"
                continue
            if what and ("Used" in line or "spill" in line):
                print(f"  ptxas {name}: {what}: "
                      f"{line.split(':', 1)[-1].strip()}")


def check(kernel, fn, ref_fn, args, kw, label, kargs=None, kkw=None):
    """A kernel against its plain version on the same inputs (the kernel
    given ``kargs`` where its table is laid out for it, and ``kkw``, the
    engine's laid W table); returns (max |d|, the plain version's sums)."""
    before = fn.LAUNCHES
    ck = fn(*(kargs or args), **kw, **(kkw or {}))
    cp = ref_fn(*args, **kw)
    torch.cuda.synchronize()
    launches = fn.LAUNCHES - before
    fn.LAUNCHES = before  # the main path's count excludes these
    if not bool(torch.isfinite(ck).all()):
        fail(f"{kernel} ({label}) gave non-finite sums")
    err = float((ck - cp).abs().max())
    limit = KERNEL_REL * float(cp.abs().max())
    print(f"{kernel} {label}, {args[-1]} draws in {launches} launches: "
          f"max |kernel - plain| = {err:.3e} (limit {limit:.3e}; "
          f"max |sum| {float(cp.abs().max()):.3e})")
    if not err <= limit:
        fail(f"{kernel} ({label}) disagrees with its plain version")
    return err, cp


def tf32_control(kernel, ref_fn, args, kw, c32, label, n=512):
    """The plain version with its products at TF32 against the fp32 one
    on the first ``n`` draws; prints how far over the limit it lands."""
    n = min(n, args[-1])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ct = ref_fn(*args[:-1], n, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    c32 = c32.reshape(2, -1, 2)[:, :n].reshape(-1, 2)
    terr = float((ct - c32).abs().max())
    limit = KERNEL_REL * float(c32.abs().max())
    print(f"control: plain {kernel} {label} with TF32 products vs fp32, {n} "
          f"draws: max |d| = {terr:.3e}, {terr / limit:.1f}x the limit")
    if not terr > limit:
        fail(f"the limit does not reject TF32 products ({kernel} {label})")


def time_kernel(fn, ref_fn, args, kw, ntime=NTIME, reps=(10, 3),
                kargs=None, kkw=None):
    """(kernel ms, plain ms) per ``ntime`` draws (the kernel given
    ``kargs`` and ``kkw`` if any); the launches do not count."""
    args = args[:-1] + (ntime,)
    kargs = args if kargs is None else kargs[:-1] + (ntime,)
    before = fn.LAUNCHES
    ms = cuda_ms(lambda: fn(*kargs, **kw, **(kkw or {})), reps[0])
    plain_ms = cuda_ms(lambda: ref_fn(*args, **kw), reps[1])
    fn.LAUNCHES = before
    return ms, plain_ms


def time_pass1(T, nbatch, mixed, label, reps):
    """Pass 1 of K2 and K7 alone (``fast_synth_pass1``): device ms per call
    of ``nbatch`` draws, and the FLOP/s of its two products (4N^3 mixing
    for 'mixed', 8N^2 P for G', P the padded pupil the kernel computes).
    Beside it its yardsticks (PyTorch calls of the same shapes, TF32 off,
    which the port never calls): one ``torch.matmul`` of the mixing
    product, (2 draws N x N) @ (N x N) for both parts of the noise
    ('mixed'), and one complex64 ``torch.matmul`` of G' = X' W^T, (draws N
    x N) @ (N x P). Returns (ms, TFLOP/s, {yardstick: ms}); the launches
    here do not count."""
    from fast_tpu_torch.ops import synth_detect as sd
    N = T["s_t"].shape[0]
    P = sd.padded_pupil(T["wr"].shape[0])
    mix = T["mix"] if mixed else None
    before = sd.synth_pass1.LAUNCHES
    ms = cuda_ms(lambda: sd.synth_pass1(SEED, T["s_t"], T["wr"], T["wi"],
                                        nbatch, mix=mix,
                                        laid=T.get("w_laid")), reps)
    sd.synth_pass1.LAUNCHES = before
    tflops = nbatch * ((4 * N ** 3 if mixed else 0) + 8 * N * N * P) / (
        ms * 1e9)
    g = torch.Generator(device=DEVICE).manual_seed(13)
    lib = {}
    if mixed:
        u = torch.rand((2 * nbatch * N, N), device=DEVICE, generator=g)
        lib["pass1_library_mix_ms"] = cuda_ms(
            lambda: torch.matmul(u, T["mix"]), reps)
        del u
    x = torch.complex(*torch.randn((2, nbatch * N, N), device=DEVICE,
                                   generator=g))
    wt = torch.complex(T["wr"], T["wi"]).T
    lib["pass1_library_gprime_ms"] = cuda_ms(lambda: torch.matmul(x, wt),
                                             reps)
    del x
    torch.cuda.empty_cache()
    print(f"pass 1 {label}: {ms:.3f} ms per {nbatch} complex draws, "
          f"{tflops:.1f} TFLOP/s of its products (3xTF32 wgmma); "
          f"yardsticks (TF32 off): "
          + ("" if not mixed else
             f"mixing torch.matmul {lib['pass1_library_mix_ms']:.3f} ms, ")
          + f"G' complex64 torch.matmul {lib['pass1_library_gprime_ms']:.3f}"
          f" ms")
    return ms, tflops, lib


def k2_detect_alone(T, nbatch, npup, reps, label="256^2"):
    """K2's detect pass alone (``colfac_detect.detect_pass`` on the G' of
    K2's pass 1, 3xTF32 ``wgmma`` from the engine's laid W table), with its
    FLOP/s over the pupil's ``npup`` px and its bound, beside its
    yardstick: one complex64 ``torch.matmul`` of W @ G' (TF32 off), which
    also computes, and writes out, what K7's screens pass does. The
    launches do not count."""
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    N, P = T["s_t"].shape[0], T["wr"].shape[0]
    b1, b2 = sd.synth_pass1.LAUNCHES, cd.detect_pass.LAUNCHES
    laid = T["w_laid"]
    gr, gi = sd.synth_pass1(SEED, T["s_t"], T["wr"], T["wi"], nbatch,
                            mix=T["mix"], laid=laid)
    ms = cuda_ms(lambda: cd.detect_pass(gr, gi, T["wr"], T["wi"],
                                        T["pm_t"], laid=laid), reps)
    sd.synth_pass1.LAUNCHES, cd.detect_pass.LAUNCHES = b1, b2
    wc = torch.complex(T["wr"], T["wi"])
    gc = torch.complex(gr, gi)
    del gr, gi
    lib_ms = cuda_ms(lambda: torch.matmul(wc, gc), reps)
    del gc
    torch.cuda.empty_cache()
    flops = nbatch * 8 * npup * npup * N
    bound = _bound(flops, 4 * (2 * nbatch * N * P + 2 * P * N + P * P
                               + 4 * nbatch))
    print(f"K2 detect pass alone at {label}: {ms:.3f} ms per {nbatch} draws "
          f"({flops / ms / 1e9:.1f} TFLOP/s over {npup} px, 3xTF32 "
          f"wgmma), bound {bound[0]:.3f} ms ({bound[1]}; "
          f"{bound[0] / ms:.1%} of it), yardstick complex64 torch.matmul "
          f"(TF32 off) {lib_ms:.3f} ms")
    return {"detect_ms": ms, "detect_tflops": flops / ms / 1e9,
            "detect_bound_ms": bound[0], "detect_library_ms": lib_ms}


def k7_screens_alone(T, nbatch, npup, label, reps=3, lib_ms=None):
    """K7's screens pass alone (``synth_detect.screens_pass``, H^T =
    G'^T W^T in 3xTF32 ``wgmma`` from the laid W table, the screens
    written out) on the G' of K7's pass 1: held element by element against
    its plain version on the same G' within 2N 2^-24 max |phi|, then (with
    ``reps``) timed with its FLOP/s over the pupil's ``npup`` px and its
    bound beside its yardstick, one complex64 ``torch.matmul`` of W @ G'
    (TF32 off; ``lib_ms`` if already timed). The launches do not count."""
    from fast_tpu_torch.ops import synth_detect as sd
    N, Pp = T["s_t"].shape[0], T["wr"].shape[0]
    laid = T.get("w_laid")
    b1, b2 = sd.synth_pass1.LAUNCHES, sd.screens_pass.LAUNCHES
    gr, gi = sd.synth_pass1(SEED, T["s_t"], T["wr"], T["wi"], nbatch,
                            stream=2, laid=laid)
    got = sd.screens_pass(gr, gi, T["wr"], T["wi"], npup, laid=laid)
    ref = sd.screens_pass_reference(gr, gi, T["wr"], T["wi"], npup)
    torch.cuda.synchronize()
    if got.shape != (2 * nbatch, npup, npup) or not bool(
            torch.isfinite(got).all()):
        fail(f"K7's screens pass ({label}) gave screens that are not finite "
             f"of shape (2 * draws, {npup}, {npup})")
    err, top = float((got - ref).abs().max()), float(ref.abs().max())
    limit = 2 * N * 2.0 ** -24 * top
    del got, ref
    print(f"K7 screens pass alone {label}, {nbatch} draws: max |kernel - "
          f"plain| = {err:.3e} rad on the same G' (limit {limit:.3e} = 2N "
          f"2^-24 max |phi|; {err / limit:.3f} of it)")
    if not err <= limit:
        fail(f"K7's screens pass ({label}) disagrees with its plain version")
    out = {"screens_max_abs_err": err}
    if reps:
        ms = cuda_ms(lambda: sd.screens_pass(gr, gi, T["wr"], T["wi"], npup,
                                             laid=laid), reps)
        if lib_ms is None:
            wc = torch.complex(T["wr"], T["wi"])
            gc = torch.complex(gr, gi)
            lib_ms = cuda_ms(lambda: torch.matmul(wc, gc), reps)
            del gc
        flops = nbatch * 8 * npup * npup * N
        bound = _bound(flops, 4 * (2 * nbatch * N * Pp + 2 * Pp * N
                                   + 2 * nbatch * npup * npup))
        print(f"K7 screens pass alone at {label}: {ms:.3f} ms per {nbatch} "
              f"draws ({flops / ms / 1e9:.1f} TFLOP/s over {npup} px, 3xTF32 "
              f"wgmma), bound {bound[0]:.3f} ms ({bound[1]}; "
              f"{bound[0] / ms:.1%} of it), yardstick complex64 torch.matmul "
              f"(TF32 off) {lib_ms:.3f} ms")
        out.update(screens_ms=ms, screens_tflops=flops / ms / 1e9,
                   screens_bound_ms=bound[0], screens_library_ms=lib_ms)
    sd.synth_pass1.LAUNCHES, sd.screens_pass.LAUNCHES = b1, b2
    del gr, gi
    torch.cuda.empty_cache()
    return out


def colfac_passes(kernel, pass1, table, K, npup, T, nbatch, kw, reps):
    """The two passes of K1 or K3 alone, 'mixed' noise: pass 1 (``pass1``
    on ``table``, the engine's laid table; ``colfac_pass1`` or
    ``split_pass1``, 3xTF32 ``wgmma`` from the laid table) and the detect
    pass (``colfac_detect.detect_pass``, H^T = G'^T W^T in 3xTF32
    ``wgmma`` from the engine's laid W table, then sincos and the sums) on
    its G'. Their ms per ``nbatch``
    draws, FLOP/s and bounds count the pupil's own ``npup`` px, as the
    kernels' bounds do, with pass 1 as the real (draws x K) @ (K x 2 npup)
    product per column it is. Beside each, its yardstick (a PyTorch call
    of the same shapes, TF32 off, which the port never calls): one batched
    ``torch.bmm`` of (draws x K) @ (K x 2P) per column, and one complex64
    ``torch.matmul`` of W @ G'. The launches here do not count."""
    from fast_tpu_torch.ops import colfac_detect as cd
    N, P = table.shape[0], table.shape[2]
    b1, b2 = pass1.LAUNCHES, cd.detect_pass.LAUNCHES
    p1_ms = cuda_ms(lambda: pass1(SEED, table, nbatch, **kw), reps)
    gr, gi = pass1(SEED, table, nbatch, **kw)
    det_ms = cuda_ms(lambda: cd.detect_pass(gr, gi, T["wr"], T["wi"],
                                            T["pm_t"], laid=T["w_laid"]),
                     reps)
    pass1.LAUNCHES, cd.detect_pass.LAUNCHES = b1, b2
    g = torch.Generator(device=DEVICE).manual_seed(13)
    z = torch.randn((N, nbatch, K), device=DEVICE, generator=g)
    b = torch.randn((N, K, 2 * P), device=DEVICE, generator=g)
    lib1_ms = cuda_ms(lambda: torch.bmm(z, b), reps)
    del z, b
    wc = torch.complex(T["wr"], T["wi"])
    gc = torch.complex(gr, gi)
    del gr, gi
    lib2_ms = cuda_ms(lambda: torch.matmul(wc, gc), reps)
    del gc
    torch.cuda.empty_cache()
    f1 = nbatch * N * 2 * K * 2 * npup
    f2 = nbatch * 8 * npup * npup * N
    bound1 = _bound(f1, 4 * (N * K * 2 * P + 2 * nbatch * N * P))
    bound2 = _bound(f2, 4 * (2 * nbatch * N * P + 2 * P * N + P * P
                             + 4 * nbatch))
    out = {"pass1_ms": p1_ms, "pass1_tflops": f1 / p1_ms / 1e9,
           "pass1_bound_ms": bound1[0], "pass1_library_ms": lib1_ms,
           "detect_ms": det_ms, "detect_tflops": f2 / det_ms / 1e9,
           "detect_bound_ms": bound2[0], "detect_library_ms": lib2_ms}
    for name, ms, lib, bound in (("pass 1", p1_ms, lib1_ms, bound1),
                                 ("detect pass", det_ms, lib2_ms, bound2)):
        flops = f1 if name == "pass 1" else f2
        print(f"{kernel} {name} alone: {ms:.3f} ms per {nbatch} draws "
              f"({flops / ms / 1e9:.1f} TFLOP/s over {npup} px, 3xTF32 "
              f"wgmma), bound "
              f"{bound[0]:.3f} ms ({bound[1]}; "
              f"{bound[0] / ms:.1%} of it), yardstick "
              f"{'torch.bmm' if name == 'pass 1' else 'complex64 torch.matmul'}"
              f" (TF32 off) {lib:.3f} ms")
    return out


def phase_k2(sim, sim_default):
    from fast_tpu_torch.ops import synth_detect as sd
    T = sim.tables
    N, P = sim.Npxls, sim.Npxls_pup
    res = {"max_abs_err": 0.0}
    for noise in ("mixed", "gauss"):
        kw = {"mix": T["mix"] if noise == "mixed" else None}
        args = (SEED, T["s_t"], T["wr"], T["wi"], T["pm_t"], NDRAWS)
        lw = {"laid": T["w_laid"]}  # the engine's laid W table
        err, cp = check("K2", sd.synth_detect, sd.synth_detect_reference,
                        args, kw, f"{noise} flagship 256^2, P={P}", kkw=lw)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        Td = sim_default.tables
        kwd = {"mix": Td["mix"] if noise == "mixed" else None}
        err = check("K2", sd.synth_detect, sd.synth_detect_reference,
                    (SEED, Td["s_t"], Td["wr"], Td["wi"], Td["pm_t"], 512),
                    kwd, f"{noise} default config 102^2, P=102",
                    kkw={"laid": Td["w_laid"]})[0]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        tf32_control("K2", sd.synth_detect_reference, args, kw, cp, noise)

        ms, plain_ms = time_kernel(sd.synth_detect,
                                   sd.synth_detect_reference, args, kw,
                                   kkw=lw)
        bound_ms, bound_by, flops = k2_bound(N, P, NTIME, noise == "mixed")
        print(f"K2 {noise}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
              f"bound {bound_ms:.3f} ms ({flops / NTIME / 1e6:.1f} MFLOP "
              f"per draw; {bound_ms / ms:.1%} of it) per {NTIME} complex "
              f"draws at 256^2")
        sfx = "" if noise == "mixed" else "_gauss"
        p1_ms, p1_tflops, p1_lib = time_pass1(T, NTIME, noise == "mixed",
                                              f"K2 {noise} 256^2, P={P}", 10)
        res.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: bound_ms, "bound_by" + sfx: bound_by,
                    "pass1_ms" + sfx: p1_ms,
                    "pass1_tflops" + sfx: p1_tflops,
                    **{k + sfx: v for k, v in p1_lib.items()}})
        if noise == "mixed":
            res.update(k2_detect_alone(T, NTIME, P, 10))

    # subharmonic screens of ~1 rad rms, two launches: the second takes
    # its screens from draw 4096
    g = torch.Generator(device=DEVICE).manual_seed(11)
    sh = torch.complex(*torch.randn((2, NDRAWS, P, P), device=DEVICE,
                                    generator=g))
    sh_t = sd.pack_subharm(sh, T["wr"].shape[0])
    err = check("K2", sd.synth_detect, sd.synth_detect_reference,
                (SEED, T["s_t"], T["wr"], T["wi"], T["pm_t"], NDRAWS),
                {"mix": T["mix"], "sh_t": sh_t},
                "mixed with subharmonic screens, 256^2",
                kkw={"laid": T["w_laid"]})[0]
    res["max_abs_err_sh"] = err

    g = torch.Generator(device=DEVICE).manual_seed(7)
    worst = 0.0
    for scale in (1.0, 30.0, 1000.0, 4096.0):
        phi = torch.rand(1 << 20, device=DEVICE, generator=g) * 2 - 1
        phi = phi * scale
        s, c = sd.device_sincos(phi)
        p64 = phi.double()
        worst = max(worst, float((s.double() - p64.sin()).abs().max()),
                    float((c.double() - p64.cos()).abs().max()))
    print(f"device sincos: max |err| vs float64 over |phi| <= 4096: "
          f"{worst:.3e} (bound 2e-7)")
    if not worst < 2e-7:
        fail("device sincos exceeds 2e-7")
    return res


def phase_k1(sim):
    from fast_tpu_torch.ops import colfac_detect as cd
    T = sim.tables
    N, P = sim.Npxls, sim.Npxls_pup
    res = {"max_abs_err": 0.0}
    for noise in ("mixed", "gauss"):
        mixed = noise == "mixed"
        # the plain version's table, and the kernel's laid out from it for
        # three TF32 passes (the engine's holds one at PRECISION='default')
        S = cd.pack_tables(T["L"], mixed=mixed)
        laid = cd.lay_tables(S)
        args = (SEED, S, T["wr"], T["wi"], T["pm_t"], NDRAWS)
        kargs = (SEED, laid) + args[2:]
        kw = {"mixed": mixed, "stream": 3}
        lw = {"laid": T["w_laid"]}  # the engine's laid W table
        err, cp = check("K1", cd.colfac_detect, cd.colfac_detect_reference,
                        args, kw, f"{noise} flagship 512^2, P={P}", kargs,
                        lw)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        tf32_control("K1", cd.colfac_detect_reference, args, kw, cp, noise)

        ms, plain_ms = time_kernel(cd.colfac_detect,
                                   cd.colfac_detect_reference, args, kw,
                                   kargs=kargs, kkw=lw)
        bound_ms, bound_by, flops = k1_bound(N, P, NTIME, mixed)
        print(f"K1 {noise}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
              f"bound {bound_ms:.3f} ms ({flops / NTIME / 1e6:.1f} MFLOP "
              f"per draw; {bound_ms / ms:.1%} of it) per {NTIME} complex "
              f"draws at 512^2")
        sfx = "" if mixed else "_gauss"
        res.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: bound_ms, "bound_by" + sfx: bound_by})
        if mixed:
            res.update(colfac_passes("K1", cd.colfac_pass1, laid, S.shape[1],
                                     P, T, NTIME, {"mixed": True}, 10))
    return res


def si_standard_error(r, blocks=16):
    """Standard error of a series' scintillation index, from the spread of
    the index over ``blocks`` consecutive blocks."""
    b = r[:r.size // blocks * blocks].reshape(blocks, -1)
    return float((b.var(axis=1) / b.mean(axis=1) ** 2).std(ddof=1)
                 / np.sqrt(blocks))


def agree(r_k, r_p, what, name="kernel", short=False, other="matmul"):
    """Mean within MEAN_SIGMAS combined standard errors, scintillation
    index within SI_REL; prints both. ``short``: a run too short for
    SI_REL holds the index to SI_SIGMAS combined standard errors instead,
    where that is the wider of the two. ``other`` names ``r_p``'s path."""
    for who, r in ((name, r_k), (other, r_p)):
        if r.ndim != 1 or not np.isfinite(r).all():
            fail(f"{what}: {who} path output is not finite of shape (n,)")
    se = np.hypot(r_k.std() / np.sqrt(r_k.size), r_p.std() / np.sqrt(r_p.size))
    dmean = abs(r_k.mean() - r_p.mean())
    si_k, si_p = r_k.var() / r_k.mean() ** 2, r_p.var() / r_p.mean() ** 2
    si_tol, why = SI_REL * si_p, f"{SI_REL:.0%}"
    if short:
        si_se = np.hypot(si_standard_error(r_k), si_standard_error(r_p))
        if SI_SIGMAS * si_se > si_tol:
            si_tol = SI_SIGMAS * si_se
            why = (f"{SI_SIGMAS:.0f} combined standard errors, one being "
                   f"{si_se / si_p:.1%} of the index at {r_k.size} and "
                   f"{r_p.size} realizations: wider than {SI_REL:.0%}")
    print(f"{what}: mean normalised power {name} {r_k.mean():.6f}, {other} "
          f"{r_p.mean():.6f} ({dmean / se:.2f} combined SE); scintillation "
          f"index {name} {si_k:.5f}, {other} {si_p:.5f} (limit {why})")
    if not dmean <= MEAN_SIGMAS * se:
        fail(f"{what}: mean power of the {name} path disagrees with {other}")
    if not abs(si_k - si_p) <= si_tol:
        fail(f"{what}: scintillation index of the {name} path disagrees")


def series(res):
    return np.asarray(res._r, np.float64)


def slice_run(sim, kernel, counter, other, label):
    """The main path of one slice: ``sim.run()`` with both kernels' counts
    at 0; fails unless it launched ``kernel`` and not ``other``. Returns
    (series, launches, seconds)."""
    other.LAUNCHES = 0
    before = by_passes()
    (res, secs), launches = launches_of(lambda: timed_run(sim), counter)
    check_passes(before, sim._precision, label)
    r = series(res)
    print(f"{label}: {sim.Niter} realizations in {secs:.3f} s (first run), "
          f"{launches} {kernel} launches, {other.LAUNCHES} of the other "
          f"kernel; avg power {res.avg_power_dBm:.4f} dBm, phs_var "
          f"{sim.phs_var:.4f} rad^2")
    if launches == 0:
        fail(f"{label}: Fast.run() did not launch {kernel}")
    if other.LAUNCHES:
        fail(f"{label}: Fast.run() launched the other kernel")
    if r.shape != (sim.Niter,) or not np.isfinite(r).all():
        fail(f"{label}: output is not finite of shape (NITER,)")
    return r, launches, secs


def ar_inputs(sim, noise):
    """One AR series' arguments from a temporal sim's tables: the initial
    state drawn with numpy from SEED and coloured by sqrt(PSD) df, the
    phasor and noise scale (pure frozen flow: the unit phasor and none),
    W and pupil * mode."""
    T = sim.tables
    rng = np.random.default_rng(SEED & 0xFFFFFFFF)
    z = rng.standard_normal((2,) + tuple(T["sqrt_psd_df"].shape),
                            dtype=np.float32)
    z = torch.from_numpy(z).to(DEVICE)
    a0 = torch.complex(z[0], z[1]) * T["sqrt_psd_df"]
    if noise is None:
        return a0, T["step_phasor"], None, T["W"], T["pm"]
    return a0, T["ph"], T["ns"], T["W"], T["pm"]


def check_ar(kernel, fn, inputs, nsteps, kw, label):
    """An AR kernel against the plain version on the same inputs: the
    final state bit for bit, the couplings within the limit. Returns (max
    |d| of the couplings, the plain version's couplings)."""
    from fast_tpu_torch.ops import ar_flow as af
    before = fn.LAUNCHES
    ck, ak = fn(SEED, *inputs, nsteps, **kw)
    cp, ap = af.ar_flow_reference(SEED, *inputs, nsteps,
                                  noise=kw.get("noise", "uniform"))
    torch.cuda.synchronize()
    launches = fn.LAUNCHES - before
    fn.LAUNCHES = before  # the main path's count excludes these
    if not bool(torch.isfinite(ck).all()):
        fail(f"{kernel} ({label}) gave non-finite sums")
    serr = float((ak - ap).abs().max())
    err = float((ck - cp).abs().max())
    limit = KERNEL_REL * float(cp.abs().max())
    print(f"{kernel} {label}, {nsteps} steps in {launches} launches: max "
          f"|kernel - plain| = {err:.3e} in the couplings (limit "
          f"{limit:.3e}; max |sum| {float(cp.abs().max()):.3e}), {serr:.3e} "
          f"in the final state (limit 0; max |a| "
          f"{float(ap.abs().max()):.3e})")
    if serr != 0.0:
        fail(f"{kernel} ({label}): the final state differs from the plain "
             f"version's")
    if not err <= limit:
        fail(f"{kernel} ({label}) disagrees with its plain version")
    return err, cp


def ar_tf32_control(kernel, inputs, noise, c32, label):
    """The plain version with its products at TF32 against the fp32 one
    on the first 512 steps; must land outside the limit."""
    from fast_tpu_torch.ops import ar_flow as af
    n = min(512, c32.shape[0])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ct = af.ar_flow_reference(SEED, *inputs, n,
                                  noise=noise or "uniform")[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    terr = float((ct - c32[:n]).abs().max())
    limit = KERNEL_REL * float(c32[:n].abs().max())
    print(f"control: plain {kernel} {label} with TF32 products vs fp32, {n} "
          f"steps: max |d| = {terr:.3e}, {terr / limit:.1f}x the limit")
    if not terr > limit:
        fail(f"the limit does not reject TF32 products ({kernel} {label})")


def ar_passes(label, fn):
    """Each AR pass's device time in one profiled call of ``fn``: {pass:
    ms} for ``ar_update``, ``ar_dft``, ``ar_detect`` (with its
    ``sum_tiles``) and the whole device time."""
    from fast_tpu_torch.utils.profiling import device_breakdown
    _, busy, per = device_breakdown(fn)
    out = {p: 1e3 * sum(v for k, v in per.items() if re.search(pat, k))
           for p, pat in (("ar_update", "ar_update"), ("ar_dft", "ar_dft"),
                          ("ar_detect", "ar_detect|sum_tiles"))}
    out["device"] = 1e3 * busy
    print(f"passes {label}: " + ", ".join(
        f"{k} {v:.3f} ms ({v / out['device']:.1%})" for k, v in out.items()
        if k != "device") + f" of {out['device']:.3f} ms device time")
    return out


def time_ar(fn, inputs, nsteps, kw, reps):
    """(kernel ms, plain ms, each pass's ms) per ``nsteps`` steps; the
    launches do not count."""
    from fast_tpu_torch.ops import ar_flow as af
    before = fn.LAUNCHES
    ms = cuda_ms(lambda: fn(SEED, *inputs, nsteps, **kw), reps)
    passes = ar_passes(f"{fn.__name__}, {nsteps} steps",
                       lambda: fn(SEED, *inputs, nsteps, **kw))
    plain_ms = cuda_ms(lambda: af.ar_flow_reference(
        SEED, *inputs, nsteps, noise=kw.get("noise", "uniform")), 1,
        warm=False)  # the checks before ran it
    fn.LAUNCHES = before
    return ms, plain_ms, passes


def phase_ar(sim_t, sim_t16):
    """K4 at the temporal flagship's shapes and K5 at the 16-layer 512^2
    link's, each against the plain version, and K5 against K4."""
    from fast_tpu_torch.ops import ar_flow as af
    k4, k5 = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    L, N, P = len(sim_t.h), sim_t.Npxls, sim_t.Npxls_pup
    for noise in (None, "uniform", "gauss"):
        label = f"{noise or 'frozen flow'} {N}^2, {L} layers, P={P}"
        inputs = ar_inputs(sim_t, noise)
        kw = {"noise": noise} if noise else {}
        err, cp = check_ar("K4", af.ar_flow_fused, inputs, NSTEPS, kw, label)
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        ar_tf32_control("K4", inputs, noise, cp, noise or "frozen flow")
        # K5's layer blocks (one layer, then three and one) against K4
        cf = af.ar_flow_fused(SEED, *inputs, 600, **kw)
        for lb in (1, 3):
            cs = af.ar_flow_streamed(SEED, *inputs, 600, lb_layers=lb, **kw)
            d = float((cs[0] - cf[0]).abs().max())
            ds = float((cs[1] - cf[1]).abs().max())
            print(f"K5 in blocks of {lb} against K4, {label}, 600 steps: max "
                  f"|d| = {d:.3e} in the couplings, {ds:.3e} in the state "
                  f"(limit 0 for both: the same sums in the same order)")
            if d != 0.0 or ds != 0.0:
                fail(f"K5 (blocks of {lb}) differs from K4 ({label})")
        if noise:
            # one Philox call serves a pair of steps: a series cut at an
            # odd step takes the second half of the pair's call
            c1, a1 = af.ar_flow_fused(SEED, *inputs, 301, **kw)
            c2, a2 = af.ar_flow_fused(SEED, a1, *inputs[1:], 299, step0=301,
                                      **kw)
            same = (torch.equal(torch.cat([c1, c2]), cf[0])
                    and torch.equal(a2, cf[1]))
            print(f"K4 {label}, 600 steps cut at the odd step 301 against "
                  f"one call: {'equal' if same else 'different'} bit for bit"
                  f" (couplings and state)")
            if not same:
                fail(f"K4 cut at an odd step differs ({label})")
        af.ar_flow_fused.LAUNCHES = af.ar_flow_streamed.LAUNCHES = 0
    inputs = ar_inputs(sim_t, "uniform")
    k4["ms"], k4["plain_ms"], k4["passes"] = time_ar(
        af.ar_flow_fused, inputs, NTIME,
        {"noise": "uniform", "laid": sim_t.tables["w_laid"]}, 5)
    k4["bound_ms"], k4["bound_by"], flops = ar_bound(L, N, P, NTIME, True)
    print(f"K4 uniform: {k4['ms']:.3f} ms kernel ({1e3 * k4['ms'] / NTIME:.3f}"
          f" us per step), {k4['plain_ms']:.3f} ms plain (the plain scan: "
          f"{1e3 * NTIME / k4['plain_ms']:.0f} steps/s), bound "
          f"{k4['bound_ms']:.3f} ms ({flops / NTIME / 1e6:.1f} MFLOP per "
          f"step; {k4['bound_ms'] / k4['ms']:.1%} of it) per {NTIME} steps "
          f"at {N}^2, {L} layers; A and G' through device memory: "
          f"{8 * N * (N + 16 * PJ) * 2 / 1e6:.2f} MB per step")
    for noise in (None, "gauss"):
        ms = cuda_ms(lambda: af.ar_flow_fused(
            SEED, *ar_inputs(sim_t, noise), NTIME,
            laid=sim_t.tables["w_laid"],
            **({"noise": noise} if noise else {})), 5)
        k4["ms_" + (noise or "frozen")] = ms
        print(f"K4 {noise or 'frozen flow'}: {ms:.3f} ms per {NTIME} steps")
    af.ar_flow_fused.LAUNCHES = 0

    L, N, P = len(sim_t16.h), sim_t16.Npxls, sim_t16.Npxls_pup
    for noise in (None, "uniform", "gauss"):
        label = f"{noise or 'frozen flow'} {N}^2, {L} layers, P={P}"
        inputs = ar_inputs(sim_t16, noise)
        kw = {"max_steps": MAX_STEPS_K5}
        if noise:
            kw["noise"] = noise
        err, cp = check_ar("K5", af.ar_flow_streamed, inputs, NSTEPS_K5, kw,
                           label)
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        if noise == "uniform":  # the products are the same in every case
            ar_tf32_control("K5", inputs, noise, cp, noise)
    inputs = ar_inputs(sim_t16, "uniform")
    lw16 = {"laid": sim_t16.tables["w_laid"]}
    k5["ms"], k5["plain_ms"], k5["passes"] = time_ar(
        af.ar_flow_streamed, inputs, MAX_STEPS_K5,
        {"noise": "uniform", **lw16}, 3)
    k5["bound_ms"], k5["bound_by"], flops = ar_bound(L, N, P, MAX_STEPS_K5,
                                                     True)
    k5["ms_4096"] = cuda_ms(lambda: af.ar_flow_streamed(
        SEED, *inputs, NTIME, noise="uniform", **lw16), 1)
    print(f"K5 uniform: {k5['ms']:.3f} ms kernel "
          f"({1e3 * k5['ms'] / MAX_STEPS_K5:.3f} us per step; "
          f"{k5['ms_4096']:.3f} ms per {NTIME} steps), {k5['plain_ms']:.3f} "
          f"ms plain, bound {k5['bound_ms']:.3f} ms "
          f"({flops / MAX_STEPS_K5 / 1e6:.1f} MFLOP per step; "
          f"{k5['bound_ms'] / k5['ms']:.1%} of it) per {MAX_STEPS_K5} steps "
          f"at {N}^2, {L} layers")
    af.ar_flow_streamed.LAUNCHES = 0
    return k4, k5


def acf_time(x):
    """Integrated autocorrelation time of a series in steps, 1 + 2 sum of
    the autocorrelation up to the first lag M with M >= 5 tau(M) (Sokal's
    window), and the lag-1 autocorrelation."""
    x = x - x.mean()
    n = x.size
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n] / np.arange(n, 0, -1)
    acf = acf / acf[0]
    tau = 1.0 + 2.0 * np.cumsum(acf[1:])
    lags = np.arange(1, n)
    ok = lags >= 5 * tau
    m = int(np.argmax(ok)) if ok.any() else n - 2
    return float(max(tau[m], 1.0)), float(acf[1])


def temporal_run(sim, kernel, counter, others, label):
    """The main path of a temporal slice: ``sim.run()`` with every
    kernel's count at 0; fails unless it launched ``kernel`` and no other,
    and returned a finite, correlated series. Returns (series, launches,
    integrated autocorrelation time)."""
    for o in others:
        o.LAUNCHES = 0
    before = by_passes()
    (res, secs), launches = launches_of(lambda: timed_run(sim), counter)
    check_passes(before, sim._precision, label)
    r = series(res)
    other = sum(o.LAUNCHES for o in others)
    if r.shape != (sim.Niter,) or not np.isfinite(r).all():
        fail(f"{label}: output is not finite of shape (NITER,)")
    tau, lag1 = acf_time(r)
    print(f"{label}: {sim.Niter} steps in {secs:.3f} s (first run), "
          f"{launches} {kernel} launches, {other} of the other kernels; avg "
          f"power {res.avg_power_dBm:.4f} dBm; lag-1 autocorrelation "
          f"{lag1:.5f}, integrated autocorrelation time {tau:.1f} steps")
    if kernel and launches == 0:
        fail(f"{label}: Fast.run() did not launch {kernel}")
    if other:
        fail(f"{label}: Fast.run() launched another kernel")
    if not lag1 > ACF_MIN:
        fail(f"{label}: lag-1 autocorrelation {lag1:.4f} is not over "
             f"{ACF_MIN}")
    return r, launches, tau


def phase_temporal(ctx):
    """The temporal slices through K4 and K5, the kernel route against
    the exact route, and a frozen-flow 'screens' run."""
    from scipy.stats import ks_2samp
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    K1, K2 = cd.colfac_detect, sd.synth_detect
    K4, K5 = af.ar_flow_fused, af.ar_flow_streamed

    sim_t = Fast(temporal(), device=DEVICE)
    t0 = time.perf_counter()
    sim_t16 = Fast(temporal(16, NPXLS=512, NITER=NITER_T16, NCHUNKS=2),
                   device=DEVICE)
    print(f"16-layer 512^2 temporal link: Fast() in "
          f"{time.perf_counter() - t0:.2f} s")
    for sim, route in ((sim_t, K4), (sim_t16, K5)):
        if sim._ar_route != "kernel" or af.select(len(sim.h)) is not route:
            fail(f"the {len(sim.h)}-layer temporal run is not on "
                 f"{route.__name__}")
        print(f"temporal {sim.Npxls}^2, {len(sim.h)} layers: alpha per layer "
              + " ".join(f"{a:.6f}" for a in sim._ar_alpha))
        if not (sim._ar_alpha < 1).any():
            fail("TEMPORAL_ALPHA='auto' gave no boiling at this length")
    k4, k5 = phase_ar(sim_t, sim_t16)

    K6 = af.ar_flow_fused_batch
    r_t, k4["launches"], tau = temporal_run(
        sim_t, "K4", K4, (K1, K2, K5, K6), "temporal slice 256^2")
    SERIES["K4"] = r_t
    r_iid = ctx["r_iid"]
    n_eff = r_t.size / tau
    se = np.hypot(r_t.std() / np.sqrt(n_eff),
                  r_iid.std() / np.sqrt(r_iid.size))
    dmean = abs(r_t.mean() - r_iid.mean())
    thin = r_t[::int(np.ceil(2 * tau))]
    pval = float(ks_2samp(thin, r_iid).pvalue)
    print(f"temporal slice 256^2 against the iid matmul run: mean normalised "
          f"power {r_t.mean():.6f} against {r_iid.mean():.6f} "
          f"({dmean / se:.2f} SE at {n_eff:.0f} effective samples); KS on "
          f"{thin.size} samples thinned by {int(np.ceil(2 * tau))}: "
          f"p = {pval:.4f}")
    if not dmean <= MEAN_SIGMAS * se:
        fail("temporal slice: the mean power disagrees with the iid run")
    if not pval > KS_PVALUE:
        fail("temporal slice: the marginal disagrees with the iid run (KS)")
    SERIES["K5"], k5["launches"], _ = temporal_run(
        sim_t16, "K5", K5, (K1, K2, K4, K6), "temporal 512^2, 16 layers")

    # the kernel route against the exact route from one seed, with boiling
    kw = dict(NITER=512, NCHUNKS=2, TEMPORAL_ALPHA=0.98, SEED=9)
    r_k = series(Fast(temporal(**kw), device=DEVICE).run())
    r_f = series(Fast(temporal(SYNTH="fft", **kw), device=DEVICE).run())
    d = float(np.abs(r_k / r_f - 1).max())
    print(f"'ar' kernel route against the SYNTH='fft' route, 512 steps from "
          f"one seed: max relative difference {d:.3e} (limit {FFT_RTOL})")
    if not d <= FFT_RTOL:
        fail("the 'ar' kernel route disagrees with the SYNTH='fft' route")
    sim_s = Fast(temporal(TEMPORAL_SYNTH="screens", NPXLS="auto", NITER=1024,
                          NCHUNKS=4), device=DEVICE)
    temporal_run(sim_s, "", K4, (K1, K2, K4, K5, K6),
                 f"'screens' run on the grown {sim_s.Npxls}^2 grid")
    sim_tf = Fast(temporal(SYNTH="fft", NITER=NITER_FFT, NCHUNKS=16),
                  device=DEVICE)
    return k4, k5, (sim_t, sim_t16, sim_tf)


# ---------------------------------------------------------------------------
# PRECISION: one TF32 pass at 'default'
# ---------------------------------------------------------------------------


def _many(x):
    return (x,) if torch.is_tensor(x) else tuple(x)


def one_pass(what, got, plain1, plain3):
    """``got`` (a kernel or a pass at PRECISION='default') against its
    plain version at 'default' (``plain1``) in units of the TF32 distance,
    |plain1 - plain3| with ``plain3`` the plain version at 'highest': the
    max within ONE_PASS_MAX of the distance's max, the rms within
    ONE_PASS_RMS of its rms (tensors, or tuples of them). A kernel that ran
    three passes reads about 1 in both. Returns the two readings."""
    got, plain1, plain3 = _many(got), _many(plain1), _many(plain3)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail(f"{what} at PRECISION='default' is not finite")

    def norms(a, b):
        d = torch.cat([(x - y).double().reshape(-1) for x, y in zip(a, b)])
        return float(d.abs().max()), float(d.pow(2).mean().sqrt())

    (mk, rk), (mt, rt) = norms(got, plain1), norms(plain1, plain3)
    print(f"{what} at 'default': max |kernel - plain| {mk:.3e}, rms "
          f"{rk:.3e}; the TF32 distance |plain('default') - "
          f"plain('highest')|: max {mt:.3e}, rms {rt:.3e}; {mk / mt:.3f} and "
          f"{rk / rt:.4f} of it (limits {ONE_PASS_MAX}, {ONE_PASS_RMS})")
    if not (mk <= ONE_PASS_MAX * mt and rk <= ONE_PASS_RMS * rt):
        fail(f"{what} at PRECISION='default' disagrees with its plain "
             f"version")
    return mk / mt, rk / rt


def same_operands(what, got, plain1, limit, unit):
    """``got``, a pass at PRECISION='default' on the same float32 operands
    as its plain version, against the plain version at 'default': the
    3xTF32 limit ``limit`` (``unit`` names it) holds, since both round the
    same values to TF32 and sum in another order. Returns the reading."""
    got, plain1 = _many(got), _many(plain1)
    err = max(float((x - y).abs().max()) for x, y in zip(got, plain1))
    print(f"{what} at 'default', on the same operands: max |kernel - "
          f"plain| {err:.3e} (limit {limit:.3e} = {unit}; {err / limit:.3f} "
          f"of it)")
    if not err <= limit:
        fail(f"{what} at PRECISION='default' disagrees with its plain "
             f"version")
    return err / limit


def in_turns(fn, reps):
    """``fn(precision)``'s device ms at 'highest' and 'default' in turns
    (highest, default, default, highest) on this card: {precision: [ms,
    ms]}."""
    out = {"highest": [], "default": []}
    for prec in ("highest", "default", "default", "highest"):
        out[prec].append(cuda_ms(lambda: fn(prec), reps))
    return out


def timed_both(res, label, fn, reps, bound):
    """The kernel ``fn(precision)`` at both precisions in turns and its
    one-pass bound (``bound``: a ``*_bound`` at PEAK_TF32); kept in
    ``res["default"]``. Its passes' times at each precision:
    scripts/torch_detect_ab.py and torch_ar_ab.py."""
    t = in_turns(fn, reps)
    b = bound[0]
    print(f"{label}: 3xTF32 " + ", ".join(f"{x:.3f}" for x in t["highest"])
          + " ms, one TF32 pass " + ", ".join(f"{x:.3f}" for x in
                                              t["default"])
          + f" ms in turns; one-pass bound {b:.3f} ms")
    res.setdefault("default", {}).update(
        ms=float(np.mean(t["default"])), ms_turns=t["default"],
        ms_highest_turns=t["highest"], bound_ms=b, bound_by=bound[1],
        shape=label)


def _restore_counts(saved):
    for w, (n, by) in saved.items():
        w.LAUNCHES, w.LAUNCHES_BY_PASSES = n, by


def phase_precision(card, res):
    """Every kernel at PRECISION='default' (one TF32 pass) against its
    plain version at 'default', pass by pass on the same inputs (the
    limits of ``one_pass`` and ``same_operands``), each kernel's time at
    both precisions in turns; then each main path at 'default' (its
    series from the slices) against a run at 'highest' from another seed,
    in distribution. ``res``: the kernels' result dicts by K1..K7, which
    gain a 'default' entry. The launches here do not count."""
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import kernel_wrappers
    from fast_tpu_torch.ops import synth_detect as sd
    t_phase = time.perf_counter()
    saved = {w: (w.LAUNCHES, dict(w.LAUNCHES_BY_PASSES)) for w in (
        *kernel_wrappers().values(), sd.synth_pass1, sd.screens_pass,
        cd.colfac_pass1, cd.split_pass1, cd.detect_pass, af.ar_dft,
        af.ar_detect)}
    D, H = "default", "highest"
    g_unit = "GPRIME_REL N 2^-24 max |G'|"

    def gprime_limit(N, g):
        return GPRIME_REL * N * 2.0 ** -24 * max(float(x.abs().max())
                                                  for x in g)

    # K2 and K1 at the flagships' shapes: pass 1, the detect pass on its G'
    # and the kernel whole
    for i, (N, lo, hi) in enumerate(PREC_IID):
        T = random_link(N, lo, hi, split=False)
        wr, wi, pm_t = T["wr"], T["wi"], T["pm_t"]
        laid = sd.laid_w(wr, wi, T["mix"], precision=D)
        nb, lab = PREC_IID_DRAWS, f"{N}^2, P={hi - lo}"
        r = res["K2" if i == 0 else "K1"].setdefault("default", {})
        for mixed in (True, False):
            noise = "mixed" if mixed else "gauss"
            if i == 0:
                mix = T["mix"] if mixed else None
                kw = dict(mix=mix, laid=laid)

                def p1(prec, kw=kw, n=nb):
                    return sd.synth_pass1(SEED, T["s_t"], wr, wi, n,
                                          precision=prec, **kw)

                def ref1(prec, mix=mix):
                    return sd.synth_pass1_reference(
                        SEED, T["s_t"], wr, wi, nb, mix=mix, precision=prec)
                who = "K2"
            else:
                S = cd.pack_tables(T["L"], mixed=mixed)
                tabs = {p: cd.lay_tables(S, sd.passes(p)) for p in (D, H)}

                def p1(prec, tabs=tabs, mixed=mixed, n=nb):
                    return cd.colfac_pass1(SEED, tabs[prec], n, mixed=mixed,
                                           stream=3, precision=prec)

                def ref1(prec, S=S, mixed=mixed):
                    return cd.colfac_pass1_reference(
                        SEED, S, nb, mixed=mixed, stream=3, precision=prec)
                who = "K1"
            g, p = p1(D), ref1(D)
            if who == "K1" and mixed:  # the noise bits, not float32 work
                r["pass1_" + noise] = same_operands(
                    f"K1 pass 1 {noise} {lab}", g, p, gprime_limit(N, p),
                    g_unit)
            else:
                r["pass1_" + noise] = one_pass(f"{who} pass 1 {noise} {lab}",
                                               g, p, ref1(H))
            d = cd.detect_pass(*g, wr, wi, pm_t, laid=laid, precision=D)
            p = sd.detect_reference(*g, wr, wi, pm_t, precision=D)
            r["detect_" + noise] = same_operands(
                f"{who}'s detect pass {noise} {lab} (its own G')", d, p,
                KERNEL_REL * float(p.abs().max()), "KERNEL_REL max |sum|")
            del g, d, p
        # the kernel whole, 'mixed' (the default noise)
        if i == 0:
            args = (SEED, T["s_t"], wr, wi, pm_t)

            def whole(prec, n=nb):
                return sd.synth_detect(*args, n, mix=T["mix"], laid=laid,
                                       precision=prec)
            ref = [sd.synth_detect_reference(*args, nb, mix=T["mix"],
                                             precision=p) for p in (D, H)]
            bound = k2_bound(N, hi - lo, NTIME, True, PEAK_TF32)
        else:
            tabs = {p: cd.lay_tables(cd.pack_tables(T["L"]), sd.passes(p))
                    for p in (D, H)}
            S = cd.pack_tables(T["L"])

            def whole(prec, n=nb, tabs=tabs):
                return cd.colfac_detect(SEED, tabs[prec], wr, wi, pm_t, n,
                                        mixed=True, stream=3, laid=laid,
                                        precision=prec)
            ref = [cd.colfac_detect_reference(SEED, S, wr, wi, pm_t, nb,
                                              mixed=True, stream=3,
                                              precision=p) for p in (D, H)]
            bound = k1_bound(N, hi - lo, NTIME, True, PEAK_TF32)
        who = "K2" if i == 0 else "K1"
        r["whole"] = one_pass(f"{who} whole, mixed {lab}", whole(D), *ref)
        timed_both(res[who], f"{who} {lab}, mixed, {NTIME} draws",
                   lambda prec: whole(prec, NTIME), 5, bound)
        del T, laid, ref
        torch.cuda.empty_cache()

    # K3, K7 and K2 at the 4 m link's 1024^2 and 402 px (416 padded)
    N, lo, hi, nb, per = PREC_WIDE
    T = random_link(N, lo, hi, card_factors=True)
    wr, wi, pm_t, lab = T["wr"], T["wi"], T["pm_t"], f"{N}^2, P={hi - lo}"
    laid = sd.laid_w(wr, wi, T["mix"], precision=D)
    tab = T["T_colfac"]
    tabs = {p: cd.lay_tables_split(tab, sd.passes(p)) for p in (D, H)}
    r3 = res["K3"].setdefault("default", {})
    g = cd.split_pass1(SEED, tabs[D], nb, mixed=True, stream=3, precision=D)
    p = cd.split_pass1_reference(SEED, tab, nb, mixed=True, stream=3,
                                 precision=D)
    r3["pass1_mixed"] = same_operands(f"K3 pass 1 mixed {lab}", g, p,
                                      gprime_limit(N, p), g_unit)
    d = cd.detect_pass(*g, wr, wi, pm_t, laid=laid, precision=D)
    q = sd.detect_reference(*g, wr, wi, pm_t, precision=D)
    r3["detect_mixed"] = same_operands(
        f"K3's detect pass mixed {lab} (its own G')", d, q,
        KERNEL_REL * float(q.abs().max()), "KERNEL_REL max |sum|")
    del g, p, d, q
    r7 = res["K7"].setdefault("default", {})
    g = sd.synth_pass1(SEED, T["s_t"], wr, wi, nb, stream=2, laid=laid,
                       precision=D)
    r7["pass1"] = one_pass(f"K7 pass 1 (Box-Muller) {lab}", g, *(
        sd.synth_pass1_reference(SEED, T["s_t"], wr, wi, nb, stream=2,
                                 precision=p) for p in (D, H)))
    s = sd.screens_pass(*g, wr, wi, hi - lo, laid=laid, precision=D)
    q = sd.screens_pass_reference(*g, wr, wi, hi - lo, precision=D)
    r7["screens"] = same_operands(
        f"K7's screens pass {lab} (its own G')", s, q,
        2 * N * 2.0 ** -24 * float(q.abs().max()), "2N 2^-24 max |phi|")
    del g, s, q
    r2 = res["K2"].setdefault("default", {})
    g = sd.synth_pass1(SEED, T["s_t"], wr, wi, nb, mix=T["mix"], laid=laid,
                       precision=D)
    r2["pass1_mixed_1024"] = one_pass(f"K2 pass 1 mixed {lab}", g, *(
        sd.synth_pass1_reference(SEED, T["s_t"], wr, wi, nb, mix=T["mix"],
                                 precision=p) for p in (D, H)))
    del g
    torch.cuda.empty_cache()
    timed_both(res["K3"], f"K3 {lab}, mixed, {per} draws",
               lambda prec: cd.colfac_detect_split(
                   SEED, tabs[prec], wr, wi, pm_t, per, mixed=True,
                   stream=3, laid=laid, precision=prec), 3,
               k3_bound(N, hi - lo, per, True, PEAK_TF32))
    del tabs
    torch.cuda.empty_cache()
    timed_both(res["K7"], f"K7 {lab}, {per} draws",
               lambda prec: sd.synth_screens(
                   SEED, T["s_t"], wr, wi, per, npup=hi - lo, laid=laid,
                   precision=prec), 3, k7_bound(N, hi - lo, per, PEAK_TF32))
    k2w = {}
    timed_both(k2w, f"K2 {lab}, mixed, {per} draws",
               lambda prec: sd.synth_detect(
                   SEED, T["s_t"], wr, wi, pm_t, per, mix=T["mix"],
                   laid=laid, precision=prec), 1,
               k2_bound(N, hi - lo, per, True, PEAK_TF32))
    r2["at_1024"] = k2w["default"]
    del T, laid, tab
    torch.cuda.empty_cache()

    # the AR kernels' two products on the same inputs, at K4's and K6's
    # tile of 1024 pairs at 256^2, K5's 256 at 512^2 and 64 at 1024^2
    g_ar = torch.Generator(device=DEVICE).manual_seed(17)
    for N, lo, hi, nj, keys in PREC_AR_PRODUCTS:
        W = ar_random(N, lo, hi, 1, 1)[3]
        wr, wi = W.real.contiguous(), W.imag.contiguous()
        laid = sd.laid_w(*sd.pad_pupil(wr, wi, None)[:2], precision=D)
        a = torch.randn((2, nj, N, N), device=DEVICE, generator=g_ar) / N
        pm = torch.rand((1, laid.shape[0], laid.shape[0]), device=DEVICE,
                        generator=g_ar)
        pr, pi = laid.wr, laid.wi
        g = af.ar_dft(a[0], a[1], wr, wi, laid=laid, precision=D)
        p = af.ar_dft_reference(a[0], a[1], pr, pi, precision=D)
        e1 = same_operands(f"ar_dft {N}^2, P={hi - lo}, {nj} pairs", g, p,
                           gprime_limit(N, p), g_unit)
        d = af.ar_detect(*g, wr, wi, pm, laid=laid, precision=D)
        q = af.ar_detect_reference(*g, pr, pi, pm, precision=D)
        e2 = same_operands(f"ar_detect {N}^2, P={hi - lo}, {nj} pairs (the "
                           f"same G')", d, q,
                           KERNEL_REL * float(q.abs().max()),
                           "KERNEL_REL max |sum|")
        for k in keys:
            res[k].setdefault("default", {})[f"ar_products_{N}"] = (e1, e2)
        del a, g, p, d, q
        torch.cuda.empty_cache()

    # K4, K5 and K6 whole: the final states bit for bit, the couplings in
    # units of the TF32 distance
    fns = {"K4": af.ar_flow_fused, "K5": af.ar_flow_streamed,
           "K6": af.ar_flow_fused_batch}
    for key, (N, lo, hi, L, B), nsteps, tsteps in PREC_AR_WHOLE:
        fn = fns[key]
        inp = ar_random(N, lo, hi, L, B)
        if B == 1:  # one series: no series axis
            inp = tuple(x[0] if x.ndim > 2 else x for x in inp)
        W = inp[3]
        laid = sd.laid_w(*sd.pad_pupil(W.real.contiguous(),
                                       W.imag.contiguous(), None)[:2],
                         precision=D)
        plain = af.ar_flow_batch_reference if B > 1 else af.ar_flow_reference
        ck, ak = fn(SEED, *inp, nsteps, laid=laid, precision=D)
        (c1, a1), (c3, _) = (plain(SEED, *inp, nsteps, precision=p)
                             for p in (D, H))
        serr = float((ak - a1).abs().max())
        print(f"{key} at 'default', {nsteps} steps: final state against the "
              f"plain version's {serr:.3e} (limit 0)")
        if serr != 0.0:
            fail(f"{key} at PRECISION='default': the final state differs "
                 f"from the plain version's")
        res[key].setdefault("default", {})["whole"] = one_pass(
            f"{key} whole {N}^2, {L} layers, {B} series", ck, c1, c3)
        timed_both(res[key], f"{key} {N}^2, {L} layers, {B} series, "
                   f"{tsteps} steps", lambda prec: fn(
                       SEED, *inp, tsteps, laid=laid, precision=prec),
                   3, ar_bound(L, N, hi - lo, tsteps, True, B, PEAK_TF32))
        del inp, laid, ck, ak, c1, a1, c3
        torch.cuda.empty_cache()
    _restore_counts(saved)
    precision_runs(card, res)
    print(f"precision phase: {time.perf_counter() - t_phase:.1f} s")


def precision_runs(card, res):
    """Each main path's series at PRECISION='default' (kept by the slices
    in SERIES) against a run at 'highest' from another seed, which must
    launch only 3xTF32 instantiations: iid in distribution as the slices
    against 'matmul' (mean within 5 combined SE, the scintillation index
    within 5% or 5 SE) and a two-sample KS test (p > KS_PVALUE); temporal
    series as the temporal slice against the iid run (the mean within 5
    SE at the effective count, KS on the series thinned beyond twice the
    integrated autocorrelation time)."""
    from scipy.stats import ks_2samp
    from fast_tpu_torch import Fast

    def wide(**kw):
        return flagship(**WIDE, NCHUNKS=4, SEED=103, PRECISION="highest",
                        NITER=NITER_W_SMALL, **kw)

    runs = (
        ("K2", flagship(SEED=101, PRECISION="highest"), False),
        ("K1", flagship(NPXLS=512, SEED=102, PRECISION="highest"), False),
        ("K3 1024^2", wide(SYNTH="pallas_colfac"), True),
        ("K7 1024^2", wide(SYNTH="pallas"), True),
        ("K4", temporal(SEED=104, PRECISION="highest"), None),
        ("K5", temporal(16, NPXLS=512, NITER=NITER_T16, NCHUNKS=2, SEED=105,
                        PRECISION="highest"), None))
    for key, params, short in runs:
        sim = Fast(params, device=DEVICE)
        before = by_passes()
        r_h = series(sim.run())
        ran = check_passes(before, "highest", f"{key} at 'highest'")
        if not ran.get(key.split()[0], (0, 0))[1]:
            fail(f"{key} at 'highest' did not launch its kernel")
        r_d = SERIES[key]
        what = f"{key}: PRECISION='default' (main path) against 'highest'"
        if short is not None:
            agree(r_d, r_h, what, "default", short=short, other="highest")
            pval = float(ks_2samp(r_d, r_h).pvalue)
            n_eff = None
        else:
            taus = [acf_time(x)[0] for x in (r_d, r_h)]
            n_eff = [x.size / t for x, t in zip((r_d, r_h), taus)]
            se = np.hypot(r_d.std() / np.sqrt(n_eff[0]),
                          r_h.std() / np.sqrt(n_eff[1]))
            dmean = abs(r_d.mean() - r_h.mean())
            step = int(np.ceil(2 * max(taus)))
            pval = float(ks_2samp(r_d[::step], r_h[::step]).pvalue)
            print(f"{what}: mean normalised power {r_d.mean():.6f} against "
                  f"{r_h.mean():.6f} ({dmean / se:.2f} SE at "
                  f"{n_eff[0]:.0f} and {n_eff[1]:.0f} effective samples)")
            if not dmean <= MEAN_SIGMAS * se:
                fail(f"{what}: the mean power disagrees")
        print(f"{what}: KS p = {pval:.4f} (limit {KS_PVALUE})")
        if not pval > KS_PVALUE:
            fail(f"{what}: the distributions disagree (KS)")
        res[key.split()[0]].setdefault("default", {})[
            "against_highest_ks_p" + ("_1024" if "1024" in key else "")] = pval
        del sim
        torch.cuda.empty_cache()


def random_link(N, lo, hi, seed=5, phase_rms=1.5, split=True,
                card_factors=False):
    """Tables of a made-up link from a numpy seed, on the card: K2's and
    K7's (``s_t``, ``wr``, ``wi``, ``pm_t``, ``mix``, ``pm``) with a PSD
    scaled to screens of ``phase_rms`` rad rms, random factors ``L`` of
    the same scale (``card_factors``: drawn on the card from the seed, for
    the 1024^2 link's 1.3 GB) and, with ``split``, K3's 'mixed' table from
    them."""
    from fast_tpu_torch import synthesis
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    npup = hi - lo
    rng = np.random.default_rng(seed)
    sqrt_ps = (rng.random((N, N)) + 0.2).astype(np.float32)
    df = phase_rms / float(np.sqrt((sqrt_ps.astype(np.float64) ** 2).sum()))
    W = synthesis.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.array(a, order="C")).to(DEVICE)

    scale = phase_rms / np.sqrt(2 * npup * N)
    if card_factors:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        L = torch.complex(*torch.randn((2, N, npup, npup), device=DEVICE,
                                       generator=g)) * scale
    else:
        L = (rng.normal(size=(N, npup, npup))
             + 1j * rng.normal(size=(N, npup, npup)))
        L = dev((L * scale).astype(np.complex64))

    wr, wi, pm_t = sd.pad_pupil(dev(W.real), dev(W.imag), dev(pm.T))
    T = dict(s_t=dev(sqrt_ps.T * np.float32(df)), wr=wr, wi=wi, pm_t=pm_t,
             pm=dev(pm), mix=dev(sd.mixing_matrix(N)), L=L)
    if split:
        T["T_colfac"] = cd.pack_tables_split(T["L"], mixed=True)
    return T


def check_screens(T, npup, ndraws, label):
    """K7 against its plain version on the same inputs (max |d phi| within
    2N 2^-24 of max |phi|: a depth-N fp32 sum per DFT side in another
    order), the plain version at TF32 as the control, and the stock-op
    detector on K7's screens against K2 with Box-Muller noise from the
    same seed. Returns max |d phi|."""
    from fast_tpu_torch import synthesis
    from fast_tpu_torch.ops import synth_detect as sd
    N = T["s_t"].shape[0]
    args = (SEED, T["s_t"], T["wr"], T["wi"], ndraws)
    kw = {"npup": npup, "stream": 2}
    before = sd.synth_screens.LAUNCHES, sd.synth_detect.LAUNCHES
    sk = sd.synth_screens(*args, **kw, laid=T.get("w_laid"))
    launches = sd.synth_screens.LAUNCHES - before[0]
    sp = sd.synth_screens_reference(*args, **kw)
    n = min(64, ndraws)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st = sd.synth_screens_reference(*args[:-1], n, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    c7 = synthesis.detector_coupling(sk, T["pm"], 1.0, 1.0)
    c2 = sd.synth_detect(SEED, T["s_t"], T["wr"], T["wi"], T["pm_t"], ndraws,
                         mix=None, stream=2)
    torch.cuda.synchronize()
    sd.synth_screens.LAUNCHES, sd.synth_detect.LAUNCHES = before
    if sk.shape != (2 * ndraws, npup, npup) or not bool(
            torch.isfinite(sk).all()):
        fail(f"K7 ({label}) gave screens that are not finite of shape "
             f"(2 * draws, {npup}, {npup})")
    err, top = float((sk - sp).abs().max()), float(sp.abs().max())
    limit = 2 * N * 2.0 ** -24 * top
    sp32 = sp.reshape(2, ndraws, npup, npup)[:, :n].reshape(st.shape)
    terr = float((st - sp32).abs().max())
    print(f"K7 {label}, {ndraws} draws in {launches} launches: max |kernel - "
          f"plain| = {err:.3e} rad (limit {limit:.3e} = 2N 2^-24 max |phi|; "
          f"max |phi| {top:.3e}, rms {float(sp.std()):.3f}); control: plain "
          f"K7 with TF32 products vs fp32, {n} draws: {terr:.3e}, "
          f"{terr / limit:.1f}x the limit")
    if not err <= limit:
        fail(f"K7 ({label}) disagrees with its plain version")
    if not terr > limit:
        fail(f"the limit does not reject TF32 products (K7 {label})")
    c2 = torch.complex(c2[:, 0], c2[:, 1])
    cerr, ctop = float((c7 - c2).abs().max()), float(c2.abs().max())
    print(f"K7 {label}: stock-op detector on its screens against K2 gauss, "
          f"one seed: max |d| = {cerr:.3e} (limit {KERNEL_REL * ctop:.3e}; "
          f"max |sum| {ctop:.3e})")
    if not cerr <= KERNEL_REL * ctop:
        fail(f"K7's screens ({label}) are not the ones K2 gauss detects")
    return err


def wide_run(sim, kernel, counters, label):
    """The main path of one wide-pupil run: ``sim.run()`` with every
    kernel's count at 0; fails unless it launched ``kernel`` (a key of
    ``counters``; None for a stock-op path) and no other. Returns
    (series, launches)."""
    for c in counters.values():
        c.LAUNCHES = 0
    before = by_passes()
    res, secs = timed_run(sim)
    torch.cuda.synchronize()
    check_passes(before, sim._precision, label)
    counts = {k: c.LAUNCHES for k, c in counters.items()}
    r = series(res)
    print(f"{label}: {sim.Niter} realizations in {secs:.3f} s (first run), "
          f"launches " + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; avg power {res.avg_power_dBm:.4f} dBm, phs_var "
          f"{sim.phs_var:.4f} rad^2")
    if kernel and counts[kernel] == 0:
        fail(f"{label}: Fast.run() did not launch {kernel}")
    if any(v for k, v in counts.items() if k != kernel):
        fail(f"{label}: Fast.run() launched another kernel")
    if r.shape != (sim.Niter,) or not np.isfinite(r).all():
        fail(f"{label}: output is not finite of shape (NITER,)")
    return r, counts.get(kernel, 0)


def phase_wide(card):
    """The wide-pupil slice: the 1024^2 link with a 4 m telescope through
    K2 ('auto'), K3 (pinned 'pallas_colfac') and K7 ('pallas'), each
    kernel against its plain version first."""
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    counters = {"K1": cd.colfac_detect, "K2": sd.synth_detect,
                "K3": cd.colfac_detect_split, "K7": sd.synth_screens,
                "K4": af.ar_flow_fused, "K5": af.ar_flow_streamed}

    def wide(**kw):
        return Fast(flagship(**WIDE, NCHUNKS=4, SEED=3, **kw), device=DEVICE)

    t0 = time.perf_counter()
    sim_2 = wide(NITER=NITER_W)
    init_s = time.perf_counter() - t0
    N, P = sim_2.Npxls, sim_2.Npxls_pup
    Pp = sd.padded_pupil(P)
    per = sd.draws_per_launch(N, Pp)
    if sim_2._synth != "pallas_fused" or (N, P) != WIDE_SHAPE:
        fail(f"the wide link resolved to {sim_2._synth!r} at {N}^2, P={P}")
    t0 = time.perf_counter()
    sim_3 = wide(SYNTH="pallas_colfac", NITER=NITER_W_SMALL)
    init3_s = time.perf_counter() - t0
    if sim_3._synth != "pallas_colfac" or "T_colfac" not in sim_3.tables:
        fail("pinned 'pallas_colfac' at a 402 px pupil is not on K3")
    sim_7 = wide(SYNTH="pallas", NITER=NITER_W_SMALL)
    sim_m = wide(SYNTH="matmul", NITER=NITER_W_MATMUL)
    T = sim_3.tables
    print(f"{N}^2 link, 4 m pupil: P={P} padded to {Pp}, {per} draws a "
          f"launch; Fast() {init_s:.2f} s ('auto', powerspec "
          f"{sim_2.timings['powerspec']:.2f} s), {init3_s:.2f} s with the "
          f"column factors ({sim_3.timings['column_factors']:.3f} s, float32 "
          f"on the card; L {T['L'].numel() * 8 / 1e9:.2f} GB, K3's laid "
          f"table {T['T_colfac'].nbytes / 1e9:.2f} GB)")

    # the kernels against their plain versions, two launches each
    label = f"{N}^2, P={P}"
    k2w, k3, k7 = ({"max_abs_err": 0.0} for _ in range(3))
    base = (SEED, T["s_t"], T["wr"], T["wi"], T["pm_t"], NDRAWS_W)
    lw = {"laid": T["w_laid"]}  # the engine's laid W table
    for noise in ("mixed", "gauss"):
        mixed = noise == "mixed"
        kw = {"mix": T["mix"] if mixed else None}
        err, cp = check("K2", sd.synth_detect, sd.synth_detect_reference,
                        base, kw, f"{noise} {label}", kkw=lw)
        k2w["max_abs_err"] = max(k2w["max_abs_err"], err)
        tf32_control("K2", sd.synth_detect_reference, base, kw, cp,
                     f"{noise} {label}", n=64)
        # the plain version's table, and the kernel's laid out from it
        # for three TF32 passes (the engine's holds one at 'default')
        tab = cd.pack_tables_split(T["L"], mixed=mixed)
        laid = cd.lay_tables_split(tab)
        args3 = (SEED, tab) + base[2:]
        kargs3 = (SEED, laid) + base[2:]
        kw3 = {"mixed": mixed, "stream": 3}
        err, cp = check("K3", cd.colfac_detect_split,
                        cd.colfac_split_reference, args3, kw3,
                        f"{noise} {label}", kargs3, lw)
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        tf32_control("K3", cd.colfac_split_reference, args3, kw3, cp,
                     f"{noise} {label}", n=64)
        if not mixed:
            del tab, laid, args3, kargs3
            continue
        # times per launch of `per` draws, 'mixed' (the default noise)
        for res, fn, ref, a, ka, k, bound in (
                (k2w, sd.synth_detect, sd.synth_detect_reference, base, None,
                 kw, k2_bound(N, P, per, True)),
                (k3, cd.colfac_detect_split, cd.colfac_split_reference,
                 args3, kargs3, kw3, k3_bound(N, P, per, True))):
            res["ms"], res["plain_ms"] = time_kernel(fn, ref, a, k, per,
                                                     (3, 1), ka, lw)
            res["bound_ms"], res["bound_by"], flops = bound
            print(f"{'K2' if res is k2w else 'K3'} mixed: {res['ms']:.3f} ms "
                  f"kernel ({res['ms'] / per:.4f} ms a draw), "
                  f"{res['plain_ms']:.3f} ms plain, bound "
                  f"{res['bound_ms']:.3f} ms ({flops / per / 1e9:.2f} GFLOP "
                  f"per draw; {res['bound_ms'] / res['ms']:.1%} of it) per "
                  f"launch of {per} complex draws at {label}")
        k2w["pass1_ms"], k2w["pass1_tflops"], lib = time_pass1(
            T, per, True, f"K2 mixed {label}", 3)
        k2w.update(lib)
        k2w.update(k2_detect_alone(T, per, P, 3, label))
        k3.update(colfac_passes("K3", cd.split_pass1, laid,
                                2 * tab.shape[1], P, T, per,
                                {"mixed": True}, 3))
        del tab, laid, args3, kargs3
    g = torch.Generator(device=DEVICE).manual_seed(11)
    sh = torch.complex(*torch.randn((2, NDRAWS_W, P, P), device=DEVICE,
                                    generator=g))
    k2w["max_abs_err_sh"] = check(
        "K2", sd.synth_detect, sd.synth_detect_reference, base,
        {"mix": T["mix"], "sh_t": sd.pack_subharm(sh, Pp)},
        f"mixed with subharmonic screens, {label}", kkw=lw)[0]
    del sh
    k7["max_abs_err"] = check_screens(T, P, NDRAWS_W, label)
    a7 = (SEED, T["s_t"], T["wr"], T["wi"], per)
    k7["ms"], k7["plain_ms"] = time_kernel(
        sd.synth_screens, sd.synth_screens_reference, a7, {"npup": P}, per,
        (3, 1), kkw=lw)
    k7["bound_ms"], k7["bound_by"], flops = k7_bound(N, P, per)
    k7["pass1_ms"], k7["pass1_tflops"], lib = time_pass1(
        T, per, False, f"K7 (Box-Muller) {label}", 3)
    k7.update(lib)
    # the screens pass alone on K7's G', its yardstick the complex64 W @ G'
    # timed beside K2's detect pass
    k7.update(k7_screens_alone(T, per, P, label,
                               lib_ms=k2w["detect_library_ms"]))
    k2w["ms_gauss"] = cuda_ms(lambda: sd.synth_detect(*base[:-1], per,
                                                      **lw), 3)
    sd.synth_detect.LAUNCHES = 0
    print(f"K7: {k7['ms']:.3f} ms kernel ({k7['ms'] / per:.4f} ms a draw; "
          f"K2 gauss {k2w['ms_gauss']:.3f} ms), {k7['plain_ms']:.3f} ms "
          f"plain, bound {k7['bound_ms']:.3f} ms ({flops / per / 1e9:.2f} "
          f"GFLOP per draw; {k7['bound_ms'] / k7['ms']:.1%} of it) per launch "
          f"of {per} complex draws at {label}")

    # a narrow grid with a wide pupil: two tiles an axis, the second ragged
    R = random_link(192, 24, 168)
    rl = "192^2, P=144 (tiles of 80 px)"
    rbase = (SEED, R["s_t"], R["wr"], R["wi"], R["pm_t"], 300)
    check("K2", sd.synth_detect, sd.synth_detect_reference, rbase,
          {"mix": R["mix"]}, f"mixed {rl}")
    check("K3", cd.colfac_detect_split, cd.colfac_split_reference,
          (SEED, R["T_colfac"]) + rbase[2:], {"mixed": True}, f"mixed {rl}")
    check_screens(R, 144, 300, rl)
    k7_screens_alone(R, 300, 144, rl, reps=0)
    del R

    # the slice: each route of the engine against 'matmul'
    r_m, _ = wide_run(sim_m, None, counters, "wide slice, matmul")
    runs = (("K2", sim_2, k2w, "launches_wide"), ("K3", sim_3, k3, "launches"),
            ("K7", sim_7, k7, "launches"))
    for name, sim, res, key in runs:
        r, res[key] = wide_run(sim, name, counters,
                               f"wide slice, SYNTH={sim.params['SYNTH']!r}")
        agree(r, r_m, f"wide slice {label}", name, short=True)
        SERIES[name + " 1024^2"] = r
    wide_rates = rates([("K2", sim_2), ("K3", sim_3), ("K7", sim_7),
                        ("matmul", sim_m), ("matmul", sim_m), ("K7", sim_7),
                        ("K3", sim_3), ("K2", sim_2)], card, "1024^2, 4 m")
    profile([("K2 1024^2, 4 m", sim_2), ("K3 1024^2, 4 m", sim_3),
             ("K7 1024^2, 4 m", sim_7), ("matmul 1024^2, 4 m", sim_m)])
    for c in counters.values():
        c.LAUNCHES = 0
    return k2w, k3, k7, wide_rates


def ar_random(N, lo, hi, L, B, boiling=True, seed=5, amp=None):
    """AR inputs of B made-up series from a numpy seed, on the card:
    white-spectrum states and noise scales per mode ``amp``, by default
    sized to screens of about a radian (the sums' round-off grows with the
    phase times sqrt(N)), random unit phasors times 0.99, W and per-series
    pupil * mode (``tests/test_torch_scan.py``'s inputs past 128^2)."""
    from fast_tpu_torch import synthesis
    rng = np.random.default_rng(seed)
    shape = (B, L, N, N)
    a_amp, n_amp = amp or (0.5 / N, 0.07 / N)
    a0 = a_amp * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    ph = 0.99 * np.exp(1j * rng.uniform(-3, 3, shape))
    ns = n_amp * rng.random(shape) if boiling else None
    W = synthesis.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pms = rng.random((B, hi - lo, hi - lo))
    return tuple(None if x is None else torch.from_numpy(
        x.astype(np.complex64 if np.iscomplexobj(x) else np.float32)).to(
            DEVICE) for x in (a0, ph, ns, W, pms))


def k6_inputs(sims):
    """K6's arguments for the series of ``sims`` (temporal sims sharing a
    grid): initial states drawn with numpy from SEED and coloured by each
    sim's sqrt(PSD) df, each sim's phasor, noise scale and pupil * mode,
    and the shared W."""
    Ts = [s.tables for s in sims]
    spd = torch.stack([t["sqrt_psd_df"] for t in Ts])
    rng = np.random.default_rng(SEED & 0xFFFFFFFF)
    z = torch.from_numpy(rng.standard_normal((2,) + tuple(spd.shape),
                                             dtype=np.float32)).to(DEVICE)
    return (torch.complex(z[0], z[1]) * spd,
            torch.stack([t["ph"] for t in Ts]),
            torch.stack([t["ns"] for t in Ts]), Ts[0]["W"],
            torch.stack([t["pm"] for t in Ts]))


def check_k6(inputs, nsteps, kw, label):
    """K6 against its plain version on the same inputs: the final states
    bit for bit, the couplings within the limit. Returns (max |d| of the
    couplings, the plain version's couplings)."""
    from fast_tpu_torch.ops import ar_flow as af
    fn = af.ar_flow_fused_batch
    before = fn.LAUNCHES
    ck, ak = fn(SEED, *inputs, nsteps, **kw)
    kw = {k: v for k, v in kw.items() if k != "max_steps"}
    cp, ap = af.ar_flow_batch_reference(SEED, *inputs, nsteps, **kw)
    torch.cuda.synchronize()
    launches = fn.LAUNCHES - before
    fn.LAUNCHES = before  # the main path's count excludes these
    if not bool(torch.isfinite(ck).all()):
        fail(f"K6 ({label}) gave non-finite sums")
    serr = float((ak - ap).abs().max())
    err = float((ck - cp).abs().max())
    limit = KERNEL_REL * float(cp.abs().max())
    print(f"K6 {label}, {inputs[0].shape[0]} series x {nsteps} steps in "
          f"{launches} launches: max |kernel - plain| = {err:.3e} in the "
          f"couplings (limit {limit:.3e}; max |sum| "
          f"{float(cp.abs().max()):.3e}), {serr:.3e} in the final states "
          f"(limit 0)")
    if serr != 0.0:
        fail(f"K6 ({label}): the final states differ from the plain "
             f"version's")
    if not err <= limit:
        fail(f"K6 ({label}) disagrees with its plain version")
    return err, cp


def phase_k6(osims):
    """K6 against its plain version on the temporal orbit pass's inputs
    (256^2, 4 layers, P=82, boiling), 'uniform' and 'gauss', each with the
    TF32 control: at the pass's own shape (all 16 series, so 16-step
    tiles, over two launches that carry the states) and on four of its
    series for 1,024 steps in one launch (64-step tiles); K6 with one
    series against K4; its time per 256 steps of all 16 series."""
    from fast_tpu_torch.ops import ar_flow as af
    k6 = {"max_abs_err": 0.0}
    s0 = osims[0]
    L, N, P = len(s0.h), s0.Npxls, s0.Npxls_pup
    full = k6_inputs(osims)
    for inputs, nsteps, kw in (
            (full, NSTEPS_K6_MAIN, {"max_steps": MAX_STEPS_K6}),
            (k6_inputs(osims[:4]), NSTEPS_K6, {})):
        for noise in ("uniform", "gauss"):
            label = f"{noise} {N}^2, {L} layers, P={P}"
            err, cp = check_k6(inputs, nsteps, dict(kw, noise=noise), label)
            k6["max_abs_err"] = max(k6["max_abs_err"], err)
            n = min(512, nsteps)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ct = af.ar_flow_batch_reference(SEED, *inputs, n,
                                                noise=noise)[0]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            terr = float((ct - cp[:n]).abs().max())
            limit = KERNEL_REL * float(cp[:n].abs().max())
            print(f"control: plain K6 {label}, {inputs[0].shape[0]} series "
                  f"with TF32 products vs fp32, {n} steps: max |d| = "
                  f"{terr:.3e}, {terr / limit:.1f}x the limit")
            if not terr > limit:
                fail(f"the limit does not reject TF32 products (K6 {label})")
    one = tuple(x[:1] if x.ndim > 2 else x for x in inputs)
    c6, a6 = af.ar_flow_fused_batch(SEED, *one, NSTEPS_K6)
    c4, a4 = af.ar_flow_fused(SEED, one[0][0], one[1][0], one[2][0], one[3],
                              one[4][0], NSTEPS_K6)
    torch.cuda.synchronize()
    same = torch.equal(c6[:, 0], c4) and torch.equal(a6[0], a4)
    print(f"K6 with one series against K4, {NSTEPS_K6} steps: "
          f"{'equal' if same else 'different'} bit for bit (couplings and "
          f"state)")
    if not same:
        fail("K6 with one series differs from K4")

    inputs, B = full, len(osims)
    lw = {"laid": s0.tables["w_laid"]}  # the engine's laid W table
    k6["ms"], k6["plain_ms"] = (
        cuda_ms(lambda: af.ar_flow_fused_batch(SEED, *inputs, 256, **lw), 5),
        cuda_ms(lambda: af.ar_flow_batch_reference(SEED, *inputs, 256), 1))
    k6["passes"] = ar_passes(f"K6, {B} series x 256 steps",
                             lambda: af.ar_flow_fused_batch(
                                 SEED, *inputs, 256, **lw))
    k6["ms_4096"] = cuda_ms(lambda: af.ar_flow_fused_batch(
        SEED, *inputs, NTIME, **lw), 2)
    k6["bound_ms"], k6["bound_by"], flops = ar_bound(L, N, P, 256, True, B)
    k4_ms = cuda_ms(lambda: af.ar_flow_fused(
        SEED, inputs[0][0], inputs[1][0], inputs[2][0], inputs[3],
        inputs[4][0], NTIME, **lw), 3)
    print(f"K6 uniform: {k6['ms']:.3f} ms kernel per 256 steps of {B} "
          f"series ({k6['ms_4096']:.3f} ms per {NTIME} steps; K4 "
          f"{k4_ms:.3f} ms per {NTIME} steps of one, x{B} = "
          f"{B * k4_ms:.3f}), {k6['plain_ms']:.3f} ms plain, bound "
          f"{k6['bound_ms']:.3f} ms ({flops / 256 / B / 1e6:.1f} MFLOP per "
          f"step and series; {k6['bound_ms'] / k6['ms']:.1%} of it) at "
          f"{N}^2, {L} layers")
    k6["ms_k4_4096"] = k4_ms
    af.ar_flow_fused_batch.LAUNCHES = af.ar_flow_fused.LAUNCHES = 0
    return k6


def pass_geometry(h_orbit, offset_deg, t_max, n):
    from fast_tpu_torch import orbit
    provider = orbit.circular_orbit_provider(h_orbit,
                                             offset_angle_deg=offset_deg)
    return orbit.sample_pass_geometry(provider,
                                      np.linspace(-t_max, t_max, n), 0.001)


def iid_pass(synth, seed, mesh):
    """The iid orbit pass of ``bench.py``'s ``measure_orbit_pass``: 16
    samples of a 600 km pass (offset 10 degrees, -240..240 s) through
    ``build_sweep`` and ``run_scan_sharded`` on ``mesh`` at 65,536
    realizations a sample; ``synth`` None leaves SYNTH to the sweep's
    default. Returns (sims, results, wall seconds with the sweep
    inside)."""
    from fast_tpu_torch import parallel, sweep
    p = flagship(NITER=NITER_OI, NCHUNKS=4)
    if synth is None:
        p.pop("SYNTH", None)
    else:
        p["SYNTH"] = synth
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geo = pass_geometry(600e3, 10.0, 240, NSAMP)
    sims = sweep.build_sweep(p, {
        "ZENITH_ANGLE": geo["zenith_angles"], "L_SAT": geo["distances"],
        "DTHETA": geo["paa"], "ANISO_DL": geo["aniso_dl"],
        "AZIMUT_SAT": geo["azimuts"]}, device=DEVICE)
    res = parallel.run_scan_sharded(sims, mesh, seed=seed)
    torch.cuda.synchronize()
    return sims, res, time.perf_counter() - t0


def temporal_pass(nsamp, niter, seed, mesh, **overrides):
    """The temporal orbit pass of ``examples/orbit_temporal_scan.py``'s
    geometry (550 km, offset 5 degrees, -90..90 s) at the temporal
    flagship: ``FAST_sat_orbit_from_geometry`` then ``run_orbit_sweep`` on
    ``mesh``. Returns (sims, results, wall seconds with the sims'
    construction inside)."""
    from fast_tpu_torch import orbit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = orbit.FAST_sat_orbit_from_geometry(
        temporal(NITER=niter, NCHUNKS=4, **overrides),
        pass_geometry(550e3, 5.0, 90, nsamp), device=DEVICE)
    res = orbit.run_orbit_sweep(d, mesh, seed=seed)
    torch.cuda.synchronize()
    keys = [f"simulation_{i}" for i in range(nsamp)]
    return [d[k] for k in keys], [res[k] for k in keys], \
        time.perf_counter() - t0


def counts(counters):
    return {k: c.LAUNCHES for k, c in counters.items()}


def phase_orbit(card, counters):
    """The two orbit passes, each through its entry points with every
    kernel's count at 0 first, on a (1, 1) scan mesh (an NCCL world of one
    rank): the iid pass through K2 against the same pass on 'matmul', and
    the temporal pass through K6 against the scan's SYNTH='fft' route;
    K6's checks; the 16 series as 16 serial runs through K4;
    run(progress=True) against run()."""
    from fast_tpu_torch import parallel
    with parallel.make_scan_mesh(1, 1, [DEVICE]) as mesh:
        return _phase_orbit(card, counters, mesh)


def _phase_orbit(card, counters, mesh):
    from fast_tpu_torch import parallel

    def zero():
        for c in counters.values():
            c.LAUNCHES = 0

    # the iid pass: K2 (the sweep's default on the card) and 'matmul'
    zero()
    before = by_passes()
    sims, res, wall = iid_pass(None, 12, mesh)
    check_passes(before, sims[0]._precision, "iid orbit pass")
    n_iid = counts(counters)
    print(f"iid orbit pass: {NSAMP} samples x {NITER_OI} realizations in "
          f"{wall:.3f} s (first; sweep_assemble "
          f"{sims[0].timings['sweep_assemble']:.3f} s, sweep_clones "
          f"{sims[0].timings['sweep_clones']:.3f} s), SYNTH "
          f"{sims[0]._synth!r}, launches " + ", ".join(
              f"{k} {v}" for k, v in n_iid.items()))
    if sims[0]._synth != "pallas_fused" or n_iid["K2"] == 0 or any(
            v for k, v in n_iid.items() if k != "K2"):
        fail("the iid orbit pass did not run through K2 alone")
    zero()
    sims_m, res_m, wall_m = iid_pass("matmul", 12, mesh)
    if any(counts(counters).values()):
        fail("the 'matmul' orbit pass launched a kernel")
    for i, (r, rm) in enumerate(zip(res, res_m)):
        agree(series(r), series(rm), f"iid orbit sample {i} (zenith "
              f"{sims[i].params['ZENITH_ANGLE']:.2f} deg)", "K2",
              short=True)
    walls = {"K2": [wall], "matmul": [wall_m]}
    for name in ("K2", "matmul", "matmul", "K2"):
        walls[name].append(iid_pass(None if name == "K2" else name, 13,
                                    mesh)[2])
    iid_rates = {k: [NSAMP * NITER_OI / w for w in v]
                 for k, v in walls.items()}
    for k, v in iid_rates.items():
        print(f"rate iid orbit pass: {k}: " + ", ".join(f"{r:.0f}" for r in v)
              + f" realizations/s ({NSAMP} x {NITER_OI}, build_sweep "
              f"inside the wall; the first is cold; {card})")

    # run(progress=True) against run(), iid
    s = sims[0]
    ref = series(s.run())
    got = series(s.run(progress=True))
    # the temporal pass: K6
    zero()
    before = by_passes()
    osims, ores, owall = temporal_pass(NSAMP, NITER_OT, 14, mesh)
    check_passes(before, osims[0]._precision, "temporal orbit pass")
    n_t = counts(counters)
    print(f"temporal orbit pass: {NSAMP} samples x {NITER_OT} steps in "
          f"{owall:.3f} s (first, the {NSAMP} Fast() inside), launches "
          + ", ".join(f"{k} {v}" for k, v in n_t.items()))
    if n_t["K6"] == 0 or any(v for k, v in n_t.items() if k != "K6"):
        fail("the temporal orbit pass did not run through K6 alone")
    lags = []
    for i, r in enumerate(ores):
        x = series(r)
        if x.shape != (NITER_OT,) or not np.isfinite(x).all():
            fail(f"temporal orbit sample {i}: not finite of shape (NITER,)")
        lags.append(acf_time(x)[1])
    print(f"temporal orbit pass: lag-1 autocorrelation per sample "
          + " ".join(f"{x:.5f}" for x in lags) + "; mean normalised power "
          + " ".join(f"{series(r).mean():.4f}" for r in ores))
    same = np.array_equal(ref, got)
    s = osims[0]
    ref_t = series(s.run())
    same_t = np.array_equal(ref_t, series(s.run(progress=True)))
    print(f"run(progress=True) against run(): iid {'equal' if same else 'DIFFERENT'}"
          f", temporal {'equal' if same_t else 'DIFFERENT'} bit for bit")
    if not (same and same_t):
        fail("run(progress=True) differs from run()")

    # the K6 route against the scan's SYNTH='fft' route on 4 samples of
    # the same pass (its samples 0, 5, 10 and 15), from one seed, at
    # PRECISION='highest' (3xTF32: the same series to FFT_RTOL) and, read
    # only, at 'default' (one TF32 pass: its rounding of phases of tens of
    # radians at these zeniths moves the power by percents); and the lag-1
    # autocorrelations of that exact route against the pass's
    rk = temporal_pass(4, NITER_OT_FFT, 9, mesh, PRECISION="highest")[1]
    rk1 = temporal_pass(4, NITER_OT_FFT, 9, mesh)[1]
    rf = temporal_pass(4, NITER_OT_FFT, 9, mesh, SYNTH="fft")[1]
    d, d_all, d1 = (max(float(np.abs(series(a)[:n] / series(b)[:n] - 1).max())
                        for a, b in zip(x, rf))
                    for x, n in ((rk, 1024), (rk, NITER_OT_FFT),
                                 (rk1, 1024)))
    print(f"temporal orbit scan, K6 route (PRECISION='highest') against the "
          f"SYNTH='fft' route, 4 samples from one seed: max relative "
          f"difference {d:.3e} over the first 1024 steps (limit {FFT_RTOL}), "
          f"{d_all:.3e} over {NITER_OT_FFT}; at 'default' {d1:.3e} over the "
          f"first 1024 (one TF32 pass, not held to the limit)")
    if not d <= FFT_RTOL:
        fail("the K6 route disagrees with the scan's SYNTH='fft' route")
    lag_f, lag_k = ([acf_time(series(r))[1] for r in x] for x in (rf, rk1))
    lag_p = [lags[i] for i in np.linspace(0, NSAMP - 1, 4).astype(int)]
    floor = min(lag_f) - ACF_ORBIT_TOL
    print(f"lag-1 autocorrelation on the pass's samples 0, 5, 10, 15: exact "
          f"route " + " ".join(f"{x:.5f}" for x in lag_f) + ", K6 route "
          + " ".join(f"{x:.5f}" for x in lag_k) + f" ({NITER_OT_FFT} steps)"
          ", K6 pass " + " ".join(f"{x:.5f}" for x in lag_p)
          + f" ({NITER_OT} steps; limit {ACF_ORBIT_TOL}); every sample of "
          f"the pass over {floor:.5f} (least {min(lags):.5f})")
    if any(abs(a - b) > ACF_ORBIT_TOL for a, b in zip(lag_p, lag_f)):
        fail("the temporal orbit pass's lag-1 autocorrelations differ from "
             "the exact route's")
    if not min(lags) > floor:
        fail(f"a temporal orbit series has lag-1 autocorrelation "
             f"{min(lags):.4f}, not over {floor:.4f}")

    k6 = phase_k6(osims)
    k6["launches"] = n_t["K6"]
    # one K6 scan against 16 serial runs through K4, warm
    scan_s, serial_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parallel.run_scan_sharded(osims, mesh, seed=15)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        serial = [s.run() for s in osims]
        torch.cuda.synchronize()
        serial_s.append(time.perf_counter() - t0)
    lags_k4 = [acf_time(series(r))[1] for r in serial]
    print(f"temporal orbit pass, warm: one K6 scan {min(scan_s):.3f} s "
          f"({NSAMP * NITER_OT / min(scan_s):.0f} steps/s), {NSAMP} serial "
          f"run() through K4 {min(serial_s):.3f} s "
          f"({NSAMP * NITER_OT / min(serial_s):.0f} steps/s; lag-1 "
          f"{min(lags_k4):.5f} to {max(lags_k4):.5f}); first pass with the "
          f"Fast() inits {NSAMP * NITER_OT / owall:.0f} steps/s ({card})")
    profile([(f"K6 temporal orbit scan, {NSAMP} x {NITER_OT} steps",
              types.SimpleNamespace(run=lambda: parallel.run_scan_sharded(
                  osims, mesh, seed=15)))])
    t_rates = {"temporal orbit pass": [NSAMP * NITER_OT / owall],
               "temporal orbit scan, warm": [NSAMP * NITER_OT / w
                                             for w in scan_s],
               f"{NSAMP} serial run() through K4, warm": [
                   NSAMP * NITER_OT / w for w in serial_s]}
    zero()
    return k6, iid_rates, t_rates, n_iid["K2"]


def definition_f64(a0, ph, ns, W, pm, z):
    """One AR series from its definition in float64 numpy on the float32
    inputs and noise ``z`` (nsteps, L, N, N) complex: the couplings
    (nsteps, 2) and the rms phase of the last step's screen."""
    a, W = a0.astype(np.complex128), W.astype(np.complex128)
    ph, ns = ph.astype(np.complex128), ns.astype(np.float64)
    pm = pm.astype(np.float64)
    out = np.zeros((len(z), 2))
    for t, zt in enumerate(z):
        a = ph * a + zt * ns
        phi = (W @ a.sum(0) @ W.T).real
        out[t] = (pm * np.cos(phi)).sum(), (pm * np.sin(phi)).sum()
    return out, float(np.sqrt((phi ** 2).mean()))


def roundoff_witness():
    """K6 and its plain version against a float64 numpy evaluation of the
    same series, on inputs of the 64^2 amplitudes (screens of tens of
    radians): at a 144 px and a 112 px pupil (one W slice, padded to 144
    and 112) on a 192^2 grid, and at a 402 px pupil (two slices of 208)
    on a 1024^2 grid. Round-off gives the two errors one size; a fault in
    the products' slices or sums would put the kernel's far above the plain
    version's."""
    from fast_tpu_torch.ops import ar_flow as af
    fn = af.ar_flow_fused_batch
    before = fn.LAUNCHES
    for N, lo, hi, L, B, nsteps in ((192, 24, 168, 3, 2, 64),
                                    (192, 40, 152, 3, 2, 64),
                                    (1024, 311, 713, 2, 1, 8)):
        inputs = ar_random(N, lo, hi, L, B, amp=AMP_64)
        ck = fn(SEED, *inputs, nsteps)[0].cpu().numpy()
        cp = af.ar_flow_batch_reference(SEED, *inputs,
                                        nsteps)[0].cpu().numpy()
        z1, z2 = af.ar_noise(SEED, 0, nsteps, B * L, N, device=DEVICE)
        z = torch.complex(z1.double(), z2.double()).cpu().numpy().reshape(
            nsteps, B, L, N, N)
        a0, ph, ns, W, pms = (x.cpu().numpy() for x in inputs)
        runs = [definition_f64(a0[s], ph[s], ns[s], W, pms[s], z[:, s])
                for s in range(B)]
        ref = np.stack([r[0] for r in runs], 1)
        top = float(np.abs(ref).max())
        ek, ep, ekp = (float(np.abs(x - y).max()) / top
                       for x, y in ((ck, ref), (cp, ref), (ck, cp)))
        print(f"round-off witness K6 {N}^2, P={hi - lo} "
              f"({-(-(hi - lo) // 208)} W slices), {B} series x "
              f"{nsteps} steps, rms phase {max(r[1] for r in runs):.1f} rad:"
              f" max |d| against float64 numpy, kernel {ek:.3e}, plain "
              f"{ep:.3e} of the largest |sum| ({top:.3e}); kernel against "
              f"plain {ekp:.3e}")
        if not ek <= ROUNDOFF_RATIO * ep:
            fail(f"K6 at {N}^2, P={hi - lo}: the kernel's error against "
                 f"float64 is over {ROUNDOFF_RATIO}x the plain version's")
    fn.LAUNCHES = before


def phase_wide_ar(card, counters, k4, k5, k6):
    """The AR kernels past a 128 px pupil: the round-off witness; K4, K5
    and K6 against their
    plain versions at a 144 px pupil on a 192^2 grid (made-up inputs) and
    at the 1024^2 link's 402 px pupil (its own tables), times per 256
    steps there, and the wide link's temporal run through K4."""
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import ar_flow as af
    K4, K5 = af.ar_flow_fused, af.ar_flow_streamed
    roundoff_witness()
    for noise in ("uniform", "gauss"):
        label = f"{noise} 192^2, P=144 (one W slice)"
        a0, ph, ns, W, pms = ar_random(192, 24, 168, 3, 3)
        one = (a0[0], ph[0], ns[0], W, pms[0])
        err = check_ar("K4", K4, one, 300, {"noise": noise, "max_steps": 256},
                       label)[0]
        k4["max_abs_err_wide"] = max(k4.get("max_abs_err_wide", 0.0), err)
        a0, ph, ns, W, pms = ar_random(192, 24, 168, 10, 1)
        err = check_ar("K5", K5, (a0[0], ph[0], ns[0], W, pms[0]), 60,
                       {"noise": noise}, f"{noise} 192^2, 10 layers, P=144")[0]
        k5["max_abs_err_wide"] = max(k5.get("max_abs_err_wide", 0.0), err)
        err = check_k6(ar_random(192, 24, 168, 3, 3), 300,
                       {"noise": noise, "max_steps": 256}, label)[0]
        k6["max_abs_err_wide"] = max(k6.get("max_abs_err_wide", 0.0), err)

    t0 = time.perf_counter()
    sim = Fast(temporal(**WIDE, NITER=NITER_WT, NCHUNKS=2, SEED=3),
               device=DEVICE)
    init_s = time.perf_counter() - t0
    L, N, P = len(sim.h), sim.Npxls, sim.Npxls_pup
    if (N, P) != WIDE_SHAPE or sim._ar_route != "kernel":
        fail(f"the wide temporal link is at {N}^2, P={P}, route "
             f"{sim._ar_route!r}")
    print(f"wide temporal link {N}^2, P={P}: Fast() {init_s:.2f} s; alpha "
          "per layer " + " ".join(f"{a:.6f}" for a in sim._ar_alpha))
    label = f"{N}^2, {L} layers, P={P}"
    for noise in (None, "uniform"):
        inputs = ar_inputs(sim, noise)
        kw = {"noise": noise} if noise else {}
        err = check_ar("K4", K4, inputs, 64, kw,
                       f"{noise or 'frozen flow'} {label}")[0]
        k4["max_abs_err_1024"] = max(k4.get("max_abs_err_1024", 0.0), err)
        err = check_ar("K5", K5, inputs, 32, dict(kw, lb_layers=1),
                       f"{noise or 'frozen flow'} {label}, blocks of 1")[0]
        k5["max_abs_err_1024"] = max(k5.get("max_abs_err_1024", 0.0), err)
    a0, ph, ns, W, pm = ar_inputs(sim, "uniform")
    two = (torch.stack([a0, a0.conj()]), torch.stack([ph, ph]),
           torch.stack([ns, ns]), W, torch.stack([pm, pm]))
    k6["max_abs_err_1024"] = check_k6(two, 32, {"noise": "uniform"},
                                      f"uniform {label}")[0]
    inputs = ar_inputs(sim, "uniform")
    lw = {"laid": sim.tables["w_laid"]}
    for res, fn, kw in ((k4, K4, lw), (k5, K5, {"lb_layers": 1, **lw})):
        res["ms_1024"] = cuda_ms(lambda: fn(SEED, *inputs, 256, **kw), 3)
        res["passes_1024"] = ar_passes(
            f"{fn.__name__} {label}, 256 steps",
            lambda: fn(SEED, *inputs, 256, **kw))
        res["plain_ms_1024"] = cuda_ms(lambda: af.ar_flow_reference(
            SEED, *inputs, 256), 1)
        res["bound_ms_1024"] = ar_bound(L, N, P, 256, True)[0]
        print(f"{'K4' if fn is K4 else 'K5 (blocks of 1)'} uniform {label}: "
              f"{res['ms_1024']:.3f} ms kernel, {res['plain_ms_1024']:.3f} "
              f"ms plain, bound {res['bound_ms_1024']:.3f} ms "
              f"({res['bound_ms_1024'] / res['ms_1024']:.1%} of it) per 256 "
              f"steps")
    for c in counters.values():
        c.LAUNCHES = 0
    r, k4["launches_1024"], tau = temporal_run(
        sim, "K4", K4, [c for k, c in counters.items() if k != "K4"],
        f"wide temporal run {N}^2, P={P}")
    k4["rate_1024"] = NITER_WT / timed_run(sim)[1]
    print(f"rate wide temporal run: {k4['rate_1024']:.0f} steps/s (warm "
          f"run() of {NITER_WT}; {card})")
    for c in counters.values():
        c.LAUNCHES = 0


# (what, N, pupil rows lo..hi): the AR kernels' first product alone at the
# (step, series) pairs of one of their tiles (ops/ar_flow.tile_steps)
DFT_CASES = [("256^2, P=82: K4's tile of 1024 steps, K6's of 64 steps x 16 "
              "series", 256, 87, 169),
             ("512^2, P=82: K5's tile of 256 steps", 512, 215, 297),
             ("1024^2, P=402: K4's tile of 64 steps", 1024, 311, 713)]
GPRIME_REL = 1.0  # G' element by element, times N 2^-24 max |G'|


def phase_ar_dft(card):
    """The AR kernels' two products alone, on the laid W table: the first
    DFT product (``fast_ar_dft``: ``ar_dft``, the second pass of
    ``csrc/detect.cuh`` with A's rows from the layer sums) against its
    plain version element by element, with the TF32 control, and the
    real-only detect (``fast_ar_detect``) on the plain G' against its
    plain version within the limit; each time and FLOP/s beside its bound,
    its plain version and its yardstick (one complex64 ``torch.matmul`` of
    the same G'; the two real ``torch.matmul`` of Re(W G')), TF32 off, the
    pass's library time (the port never calls them)."""
    from fast_tpu_torch import synthesis
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops.synth_detect import laid_w, pad_pupil
    out = {}
    for label, N, lo, hi in DFT_CASES:
        rng = np.random.default_rng(SEED & 0xFFFFFFFF)
        W = synthesis.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        wr = torch.from_numpy(np.ascontiguousarray(W.real)).to(DEVICE)
        wi = torch.from_numpy(np.ascontiguousarray(W.imag)).to(DEVICE)
        wrp, wip, _ = pad_pupil(wr, wi, None)
        laid = laid_w(wr, wi)
        P = wrp.shape[0]
        nj = af.tile_steps(N, P)
        # layer sums of screens of about a radian
        a = torch.from_numpy(rng.standard_normal((2, nj, N, N),
                                                 dtype=np.float32)
                             * np.float32(0.5 / N)).to(DEVICE)
        before = af.ar_dft.LAUNCHES, af.ar_detect.LAUNCHES
        gr, gi = af.ar_dft(a[0], a[1], wr, wi, laid=laid)
        rr, ri = af.ar_dft_reference(a[0], a[1], wrp, wip)
        torch.cuda.synchronize()
        if af.ar_dft.LAUNCHES != before[0] + 1 or not bool(
                torch.isfinite(gr).all() and torch.isfinite(gi).all()):
            fail(f"ar_dft ({label}) did not launch once or gave non-finite "
                 f"values")
        top = max(float(rr.abs().max()), float(ri.abs().max()))
        err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
        limit = GPRIME_REL * N * 2.0 ** -24 * top
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tr, ti = af.ar_dft_reference(a[0], a[1], wrp, wip)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        terr = max(float((tr - rr).abs().max()), float((ti - ri).abs().max()))
        print(f"ar_dft {label}, {nj} pairs: max |kernel - plain| = "
              f"{err:.3e} in G' (limit {limit:.3e}, {err / limit:.3f} of it;"
              f" max |G'| {top:.3e}); control: plain with TF32 products "
              f"{terr / limit:.1f}x the limit")
        if not err <= limit:
            fail(f"ar_dft ({label}) disagrees with its plain version")
        if not terr > limit:
            fail(f"the G' limit does not reject TF32 products ({label})")
        # the detect on the plain G', one series' pupil * mode
        pm_t = torch.from_numpy(rng.random((1, P, P), dtype=np.float32)).to(
            DEVICE)
        dk = af.ar_detect(rr, ri, wr, wi, pm_t, laid=laid)
        dp = af.ar_detect_reference(rr, ri, wrp, wip, pm_t[0])
        torch.cuda.synchronize()
        if af.ar_detect.LAUNCHES != before[1] + 1 or not bool(
                torch.isfinite(dk).all()):
            fail(f"ar_detect ({label}) did not launch once or gave "
                 f"non-finite sums")
        derr = float((dk - dp).abs().max())
        dlimit = KERNEL_REL * float(dp.abs().max())
        print(f"ar_detect {label}, {nj} pairs: max |kernel - plain| = "
              f"{derr:.3e} (limit {dlimit:.3e}, {derr / dlimit:.3f} of it; "
              f"max |sum| {float(dp.abs().max()):.3e})")
        if not derr <= dlimit:
            fail(f"ar_detect ({label}) disagrees with its plain version")
        reps = 20 if N <= 512 else 5
        npup = hi - lo
        ac, wc = torch.complex(a[0], a[1]), torch.complex(wrp, wip)
        for name, fn, plain, lib_fn, flops, nbytes, err_ in (
                ("ar_dft", lambda: af.ar_dft(a[0], a[1], wr, wi, laid=laid),
                 lambda: af.ar_dft_reference(a[0], a[1], wrp, wip),
                 lambda: torch.matmul(ac.transpose(-2, -1), wc.T),
                 # the pupil's own px: W's padded rows add nothing to G'
                 8 * npup * N * N * nj,
                 4 * (2 * nj * N * N + 2 * npup * N + 2 * nj * N * npup),
                 err),
                ("ar_detect",
                 lambda: af.ar_detect(rr, ri, wr, wi, pm_t, laid=laid),
                 lambda: af.ar_detect_reference(rr, ri, wrp, wip, pm_t[0]),
                 lambda: wrp @ rr - wip @ ri,
                 4 * npup * npup * N * nj,
                 4 * (2 * nj * N * npup + 2 * npup * N + npup * npup
                      + 2 * nj), derr)):
            ms = cuda_ms(fn, reps)
            plain_ms = cuda_ms(plain, reps)
            library_ms = cuda_ms(lib_fn, reps)
            bound_ms, bound_by, _ = _bound(flops, nbytes)
            res = {"pairs": nj, "max_abs_err": err_, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": flops / ms / 1e9}
            out[name, N] = res
            print(f"{name} {label}: {ms:.3f} ms ({res['tflops']:.1f} TFLOP/s "
                  f"of fp32-accurate products over {npup} px, 3xTF32 "
                  f"wgmma), plain {plain_ms:.3f} ms, library ("
                  + ("complex64 torch.matmul" if name == "ar_dft" else
                     "two real torch.matmul of Re(W G')")
                  + f", TF32 off) {library_ms:.3f} ms, bound {bound_ms:.3f} "
                  f"ms ({bound_ms / ms:.1%} of it; {bound_by}) per {nj} pairs"
                  f" ({card})")
        af.ar_dft.LAUNCHES, af.ar_detect.LAUNCHES = before
        del a, gr, gi, rr, ri, tr, ti, ac, wc, dk, dp
    torch.cuda.empty_cache()
    return out


def _sep_theory(power, M, esn0, S):
    """The fading-averaged SEP of square M-QAM on the normalised ``power``
    (numpy) and its standard error over iterations of ``S`` symbols, each
    iteration at its own power: sqrt(var(p_b) + mean(p_b (1 - p_b)) / S)
    / sqrt(B), p_b the closed form of iteration b."""
    from fast_tpu_torch import comms
    pre = (np.sqrt(M) - 1) / np.sqrt(M)
    q = comms.Q(np.sqrt(3 / (M - 1) * 10 ** (esn0 / 10) * power ** 2))
    pb = 4 * (pre * q - pre ** 2 * q ** 2)
    theory = comms.sep_qam(M, esn0, power)
    if not abs(pb.mean() - theory) <= 1e-12 * theory:
        fail("per-iteration SEP does not average to sep_qam")
    se = np.sqrt(pb.var() + (pb * (1 - pb)).mean() / S) / np.sqrt(pb.size)
    return theory, se


def phase_comms(card, fade_series, dt):
    """The FSO comms layer on the card: ``FastFSOC`` at the 256^2 flagship
    through K2 with a 16-QAM modem at EsN0 = 14 dB (its SEP against the
    fading-averaged closed form), the I-Q PDFs, GMI and MI of its field
    against the CPU port, and the fade statistics of the temporal
    flagship's K4 series ``fade_series`` (steps of ``dt`` s) on the card
    and on a CPU copy."""
    from fast_tpu_torch import FastFSOC, comms
    from fast_tpu_torch.ops import kernel_wrappers
    counters = kernel_wrappers()
    sim = FastFSOC(flagship(COHERENT=True, **COMMS), device=DEVICE)
    if sim._synth != "pallas_fused":
        fail(f"the comms run resolved to {sim._synth!r}, not pallas_fused")
    for c in counters.values():
        c.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    res, secs = timed_run(sim)
    launches = {k: c.LAUNCHES for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    m = sim.modulator
    field = comms._result_series(res)
    S = m.symbols_per_iter
    print(f"FSO comms run (FastFSOC, 256^2, COHERENT, 16-QAM, EsN0 "
          f"{COMMS_ESN0} dB, {S} symbols an iteration): {sim.Niter} "
          f"realizations in {secs:.3f} s (first run; {sim.Niter / secs:.0f} "
          f"r/s with the modem), launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; peak device memory {peak:.2f} GB")
    if launches["K2"] == 0:
        fail("FastFSOC.run() did not launch K2")
    if any(v for k, v in launches.items() if k != "K2"):
        fail("FastFSOC.run() launched another kernel")
    if not (torch.is_tensor(field) and field.is_cuda and field.is_complex()
            and field.shape == (sim.Niter,)
            and bool(torch.isfinite(torch.view_as_real(field)).all())):
        fail("the comms run's field is not a finite complex (NITER,) "
             "series on the card")
    if not (m.device.type == "cuda" and m.power.is_cuda):
        fail("the modem did not run on the card")
    secs_warm = timed_run(sim)[1]  # its launches do not count
    print(f"FSO comms run, warm: {sim.Niter / secs_warm:.0f} r/s with the "
          f"modem ({card})")
    (_, modem_s) = timed(m.run)
    rate_modem = S * sim.Niter / modem_s
    theory, se = _sep_theory(m.power.cpu().numpy(), COMMS_M, COMMS_ESN0, S)
    print(f"modem: SEP {m.sep:.6f} against the fading-averaged sep_qam "
          f"{theory:.6f} ({abs(m.sep - theory) / se:.2f} SE of {se:.2e} over "
          f"iterations; limit {SEP_SIGMAS:.0f}), EVM {m.evm:.5f}; warm "
          f"modem run {modem_s * 1e3:.1f} ms, {rate_modem:.4g} symbols/s "
          f"({card})")
    if not (np.isfinite(m.sep) and np.isfinite(m.evm)):
        fail("the modem's SEP or EVM is not finite")
    if not abs(m.sep - theory) <= SEP_SIGMAS * se:
        fail("the modem's SEP disagrees with the closed form")
    out = {"fsoc_rate": sim.Niter / secs_warm,
           "fsoc_rate_first": sim.Niter / secs,
           "modem_symbols_per_s": rate_modem,
           "modem_ms": modem_s * 1e3, "sep": m.sep,
           "sep_theory": float(theory), "sep_se": float(se), "evm": m.evm,
           "peak_gb": peak,
           "launches": launches["K2"]}

    # PDFs, GMI and MI of the run's field: the card in float32 against
    # the CPU port in float64 on the same samples
    host = field.cpu()
    pdfs = {}
    for label, kw in (("individual", {"region_size": "individual"}),
                      ("full", {"region_size": "full"}),
                      ("full, shot", {"region_size": "full", "shot": True})):
        def call(x, kw=kw):
            return comms.convolve_awgn_qam(x, COMMS_M, COMMS_NPXLS,
                                           COMMS_ESN0, **kw)
        call(field)
        got, t_card = timed(lambda: call(field))
        ref, t_cpu = timed(lambda: call(host))
        shape = (COMMS_M, COMMS_NPXLS, COMMS_NPXLS)
        if not (got.is_cuda and got.dtype == torch.float32
                and got.shape == shape and ref.dtype == torch.float64
                and bool(torch.isfinite(got).all())):
            fail(f"PDFs ({label}): not finite float32 {shape} on the card")
        d = float((got.cpu().double() - ref).abs().max())
        top = float(ref.abs().max())
        pdfs[label] = {"card_ms": t_card * 1e3, "cpu_ms": t_cpu * 1e3,
                       "max_abs_diff": d, "max_pdf": top}
        print(f"PDFs {label}, M={COMMS_M}, {COMMS_NPXLS}^2 bins, "
              f"{sim.Niter} samples: card {t_card * 1e3:.1f} ms (float32), "
              f"CPU {t_cpu * 1e3:.1f} ms (float64); largest |card - CPU| "
              f"{d:.3e} ({d / top:.2e} of the largest value)")
    out["pdfs"] = pdfs
    for name, fn in (("GMI", comms.generalised_mutual_information_qam),
                     ("MI", comms.mutual_information_qam)):
        fn(field, COMMS_M, COMMS_NPXLS, COMMS_ESN0)
        v_card, t_card = timed(lambda: fn(field, COMMS_M, COMMS_NPXLS,
                                          COMMS_ESN0))
        v_cpu, t_cpu = timed(lambda: fn(host, COMMS_M, COMMS_NPXLS,
                                        COMMS_ESN0))
        print(f"{name}: card {v_card:.6f} bit/symbol in {t_card * 1e3:.1f} "
              f"ms, CPU {v_cpu:.6f} in {t_cpu * 1e3:.1f} ms (|d| "
              f"{abs(v_card - v_cpu):.2e}; limit {MI_TOL})")
        if not (np.isfinite(v_card) and abs(v_card - v_cpu) <= MI_TOL):
            fail(f"{name} on the card disagrees with the CPU port")
        out[name] = {"card": v_card, "cpu": v_cpu, "card_ms": t_card * 1e3,
                     "cpu_ms": t_cpu * 1e3}

    # fade statistics of the temporal flagship's K4 series
    I = fade_series / fade_series.mean()
    I_host = I.cpu()
    n = I.numel()
    fades = {}
    for th in FADE_THRESHOLDS:
        below = I < th
        counts = (int(below.sum()),) + comms._fade_run_stats(below)
        below_h = I_host < th
        counts_h = (int(below_h.sum()),) + comms._fade_run_stats(below_h)
        if counts != counts_h:
            fail(f"fade counts below {th} differ: card {counts}, CPU "
                 f"{counts_h}")
        prob, dur = comms.fade_prob(I, th), comms.fade_dur(I, th, dt=dt)
        if not (np.array_equal(prob, comms.fade_prob(I_host, th),
                               equal_nan=True)
                and np.array_equal(dur, comms.fade_dur(I_host, th, dt=dt),
                                   equal_nan=True)):
            fail(f"fade_prob or fade_dur below {th} differ card / CPU")
        # NaN (fewer than 30 fades) as null: the result line is strict JSON
        fades[str(th)] = {"samples": counts[0], "fades": counts[2],
                          "fade_samples": counts[1],
                          "prob": None if np.isnan(prob) else prob,
                          "dur_s": None if np.isnan(dur) else dur}
        print(f"fades below {th} of the mean, {n} steps of {dt * 1e3:g} ms "
              f"(K4): {counts[0]} samples below (fade_prob {prob:.4e}), "
              f"{counts[2]} complete fades of {counts[1]} steps (fade_dur "
              f"{dur:.4g} s; NaN under 30 fades); equal on the card and the "
              f"CPU")
    q = torch.tensor(FADE_QUANTILES, dtype=I.dtype, device=I.device)
    qs = torch.quantile(I, q).cpu().numpy()
    qs_h = torch.quantile(I_host, q.cpu()).numpy()
    print(f"quantiles of I/<I> over the {n} steps: "
          + ", ".join(f"{a:g}: {b:.5f} (CPU {c:.5f})"
                      for a, b, c in zip(FADE_QUANTILES, qs, qs_h)))
    out["fades"] = fades
    out["quantiles"] = {str(a): float(b) for a, b in zip(FADE_QUANTILES, qs)}
    for c in counters.values():
        c.LAUNCHES = 0
    return out


def phi_rms(sim):
    """The rms of an AR sim's screens, sqrt(sum (sqrt(PSD) df)^2)."""
    return float(torch.sqrt((sim.tables["sqrt_psd_df"].double() ** 2).sum()))


def power(res):
    return np.asarray(res.power, np.float64)


def orbit_ar_spec():
    """The (2, 1) AR scan's sims: the temporal orbit pass's 16 samples at
    NITER_SCAN_T steps."""
    return {"params": temporal(NITER=NITER_SCAN_T, NCHUNKS=4),
            "geometry": pass_geometry(550e3, 5.0, 90, NSAMP)}


def orbit_iid_spec(nchunks):
    """The (1, 2) iid scan's sweep: samples 0, 5, 10, 15 of the iid orbit
    pass, NCHUNKS ``nchunks``."""
    geo = pass_geometry(600e3, 10.0, 240, NSAMP)
    pick = np.linspace(0, NSAMP - 1, NSAMP_IID_SCAN).astype(int)
    return {"params": flagship(NITER=NITER_OI, NCHUNKS=nchunks,
                               SYNTH="pallas_fused"), "sweep": {
        "ZENITH_ANGLE": geo["zenith_angles"][pick],
        "L_SAT": geo["distances"][pick], "DTHETA": geo["paa"][pick],
        "ANISO_DL": geo["aniso_dl"][pick],
        "AZIMUT_SAT": geo["azimuts"][pick]}}


def mesh_world_of_one(card, counters):
    """(a) of the mesh phase: ``make_mesh()`` with no arguments, an NCCL
    world of one rank on the card, in this process, each path with every
    count at 0 first. Returns (the serial references (b) is held against,
    {path: launches}, rates)."""
    from fast_tpu_torch import Fast, parallel
    from fast_tpu_torch.parallel import dryrun

    def sharded(sim, mesh, kernel, label):
        for c in counters.values():
            c.LAUNCHES = 0
        res, secs = timed(lambda: parallel.run_sharded(sim, mesh))
        n = counts(counters)
        print(f"mesh (a) {label}: run_sharded in {secs:.3f} s (first), "
              f"launches " + ", ".join(f"{k} {v}" for k, v in n.items()))
        if any(v for k, v in n.items() if k != kernel) or (
                kernel and not n[kernel]):
            fail(f"mesh (a) {label}: run_sharded did not run through "
                 f"{kernel or 'no kernel'} alone")
        return res, n

    ref, launches = {}, {}
    with parallel.make_mesh() as mesh:
        print(f"mesh (a): {mesh!r}")
        if mesh.backend != "nccl" or mesh.devices.shape != (1,) or \
                mesh.devices[0].type != "cuda":
            fail("make_mesh() is not an NCCL world of one rank on the card")
        # the 256^2 flagship through K2, bit for bit the serial run
        sim = Fast(flagship(), device=DEVICE)
        ref["flagship"] = power(timed_run(sim)[0])
        res, launches["K2 flagship"] = sharded(sim, mesh, "K2",
                                               "256^2 flagship")
        if not np.array_equal(power(res), ref["flagship"]):
            fail("mesh (a): run_sharded differs from run() at 256^2")
        walls = {"serial run()": [], "run_sharded": []}
        for name in ("serial run()", "run_sharded", "run_sharded",
                     "serial run()"):
            fn = sim.run if name == "serial run()" else \
                (lambda: parallel.run_sharded(sim, mesh))
            walls[name].append(timed(fn)[1])
        rates = {k: [sim.Niter / w for w in v] for k, v in walls.items()}
        ref["serial_s"] = min(walls["serial run()"])
        for k, v in rates.items():
            print(f"rate mesh (a) 256^2 flagship: {k}: " + ", ".join(
                f"{x:.0f}" for x in v) + f" realizations/s (warm; {card})")
        raw = np.asarray(res._r)
        m = parallel.sharded_moments(raw, mesh)
        m_ref = np.array([np.mean(raw.astype(np.float64) ** k)
                          for k in (1, 2, 3, 4)])
        d = float(np.abs(m / m_ref - 1).max())
        print(f"mesh (a) sharded_moments of the series: {m.tolist()} against "
              f"numpy float64, max relative difference {d:.3e} (limit "
              f"{MOMENTS_REL})")
        if not d <= MOMENTS_REL:
            fail("mesh (a): sharded_moments disagrees with numpy")
        # the 512^2 flagship through K1
        sim = Fast(flagship(NPXLS=512, NITER=NITER_SMALL), device=DEVICE)
        r_ref = power(sim.run())
        res, launches["K1 512^2"] = sharded(sim, mesh, "K1",
                                            "512^2 flagship")
        if not np.array_equal(power(res), r_ref):
            fail("mesh (a): run_sharded differs from run() at 512^2")
        # the temporal flagship with alpha = 1 through K4
        sim = Fast(temporal(TEMPORAL_ALPHA=1), device=DEVICE)
        ref["ar1"], ref["ar1_phi_rms"] = power(sim.run()), phi_rms(sim)
        res, launches["K4 alpha=1"] = sharded(
            sim, mesh, "K4", f"temporal alpha=1, {sim.Niter} steps")
        if not np.array_equal(power(res), ref["ar1"]):
            fail("mesh (a): the alpha=1 window differs from run()")
        # a 16-layer alpha = 1 series through K5
        sim = Fast(temporal(16, TEMPORAL_ALPHA=1, NITER=NITER_SCAN_T,
                            NCHUNKS=2), device=DEVICE)
        r_ref = power(sim.run())
        res, launches["K5 alpha=1, 16 layers"] = sharded(
            sim, mesh, "K5", f"temporal alpha=1, 16 layers, {sim.Niter} "
            f"steps")
        if not np.array_equal(power(res), r_ref):
            fail("mesh (a): the 16-layer alpha=1 window differs from run()")
        # the boiling temporal flagship, layer-sharded, against 'fft'
        kw = dict(NITER=NITER_BOIL, NCHUNKS=16)
        sim = Fast(temporal(**kw), device=DEVICE)
        if not (sim._ar_alpha < 1).any():
            fail("mesh (a): the temporal flagship does not boil")
        ref["layers"] = power(Fast(temporal(SYNTH="fft", **kw),
                                   device=DEVICE).run())
        res, launches["none: boiling, layers"] = sharded(
            sim, mesh, None, f"boiling temporal, {sim.Niter} steps, "
            f"{len(sim.h)} layers")
        d = float(np.abs(power(res) / ref["layers"] - 1).max())
        print(f"mesh (a) layer-sharded boiling series against the serial "
              f"SYNTH='fft' route: max relative difference {d:.3e} (limit "
              f"{FFT_RTOL})")
        if not d <= FFT_RTOL:
            fail("mesh (a): the layer-sharded series disagrees with 'fft'")
        del sim, res
        # (b)'s scan references, on a (1, 1) scan mesh in this world
        with parallel.make_scan_mesh(1, 1, [DEVICE]) as smesh:
            for name, spec, seed in (
                    ("orbit_ar", orbit_ar_spec(), 14),
                    ("orbit_iid", orbit_iid_spec(4), 12)):
                sims = dryrun.build_sims(spec, torch.device(DEVICE))
                ref[name] = [power(x) for x in parallel.run_scan_sharded(
                    sims, smesh, seed=seed)]
                del sims
    if torch.distributed.is_initialized():
        fail("mesh (a): the world of one outlived its mesh")
    torch.cuda.empty_cache()
    return ref, launches, rates


def mesh_ranks_sharing_the_card(card, ref):
    """(b) of the mesh phase: MESH_RANKS gloo ranks sharing the card,
    spawned through the dryrun twin, held against (a)'s serial references.
    Returns ({path: [launches of each rank]}, numbers)."""
    import tempfile
    from fast_tpu_torch.parallel import dryrun
    d = MESH_RANKS
    cases = [
        {"name": "flagship", "kind": "run", "repeat": 2,
         "params": flagship(NCHUNKS=NCHUNKS // d)},
        {"name": "ar1", "kind": "run", "params": temporal(TEMPORAL_ALPHA=1)},
        {"name": "layers", "kind": "run",
         "params": temporal(NITER=NITER_BOIL, NCHUNKS=16)},
        {"name": "orbit_ar", "kind": "scan", "shape": (d, 1), "seed": 14,
         "sims": orbit_ar_spec()},
        {"name": "orbit_iid", "kind": "scan", "shape": (1, d), "seed": 12,
         "sims": orbit_iid_spec(4 // d)},
    ]
    kernel = {"flagship": "K2", "ar1": "K4", "layers": None,
              "orbit_ar": "K6", "orbit_iid": "K2"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as outdir:
        reports = dryrun.spawn(dryrun.run_cases, d, cases, outdir,
                               devices=[DEVICE + ":0"] * d, timeout=600)
        arrays = dryrun.load_arrays(outdir, d)
    print(f"mesh (b): {d} gloo ranks on {DEVICE}:0, "
          f"{time.perf_counter() - t0:.1f} s with the spawn, imports and "
          f"Fast() inits")
    launches = {}
    for name, k in kernel.items():
        n = [r["launches"][name] for r in reports]
        print(f"mesh (b) {name}: launches by rank: " + "; ".join(
            f"rank {i} ({reports[i]['device']}) " + (", ".join(
                f"{c} {v}" for c, v in x.items() if v) or "none")
            for i, x in enumerate(n)) + "; host s by rank " + ", ".join(
            f"{r['seconds'][name]:.3f}" for r in reports))
        if any(any(v for c, v in x.items() if c != k) or (k and not x[k])
               for x in n):
            fail(f"mesh (b) {name}: a rank did not run through "
                 f"{k or 'no kernel'} alone")
        launches[f"{k or 'none'} {name}"] = [x[k] if k else 0 for x in n]
    for i, a in enumerate(arrays[1:], 1):
        if a.keys() != arrays[0].keys() or any(
                not np.array_equal(v, arrays[0][k]) for k, v in a.items()):
            fail(f"mesh (b): rank {i} holds other series than rank 0")
    a = arrays[0]
    for i in range(2):
        if not np.array_equal(a[f"flagship.{i}"], ref["flagship"]):
            fail(f"mesh (b): the flagship over {d} ranks at NCHUNKS "
                 f"{NCHUNKS // d} differs from the serial run at {NCHUNKS}")
    print(f"mesh (b) flagship: {d} ranks x NCHUNKS {NCHUNKS // d} equal the "
          f"serial run at NCHUNKS {NCHUNKS}, bit for bit")
    off = NITER_T // d * (d - 1)
    limit = AR_JUMP_FACTOR * off * 2.0 ** -24 * ref["ar1_phi_rms"]
    dev = float(np.abs(a["ar1.0"] - ref["ar1"]).max() / ref["ar1"].mean())
    print(f"mesh (b) alpha=1 windows against the serial K4 series: max |dI| "
          f"/ <I> {dev:.3e} (limit {AR_JUMP_FACTOR} x offset {off} x 2^-24 "
          f"x phi_rms {ref['ar1_phi_rms']:.4f} rad = {limit:.3e})")
    if not dev <= limit:
        fail("mesh (b): the alpha=1 windows disagree with the serial run")
    dl = float(np.abs(a["layers.0"] / ref["layers"] - 1).max())
    print(f"mesh (b) layer-sharded boiling series against the serial "
          f"SYNTH='fft' route: max relative difference {dl:.3e} (limit "
          f"{FFT_RTOL})")
    if not dl <= FFT_RTOL:
        fail("mesh (b): the layer-sharded series disagrees with 'fft'")
    for name, shape in (("orbit_ar", (d, 1)), ("orbit_iid", (1, d))):
        for i, r in enumerate(ref[name]):
            if not np.array_equal(a[f"{name}.{i}"], r):
                fail(f"mesh (b): the {shape} scan's sample {i} differs from "
                     f"the (1, 1) scan")
        print(f"mesh (b) {shape} scan of {len(ref[name])} samples equals the "
              f"(1, 1) scan bit for bit")
    warm = max(r["seconds"]["flagship"] for r in reports)
    rate = NITER / warm
    print(f"rate mesh (b) 256^2 flagship over {d} ranks sharing the card: "
          f"{rate:.0f} realizations/s (warm; the slower rank's host clock), "
          f"{warm / ref['serial_s']:.2f}x the serial run's "
          f"{ref['serial_s']:.3f} s ({card})")
    return launches, {"ar1_jump_max_rel": dev, "ar1_jump_limit": limit,
                      "layers_fft_rel": dl, "rate_b": rate,
                      "cost_b_over_serial": warm / ref["serial_s"]}


def phase_mesh(card, counters):
    """The multi-device layer: (a) an NCCL world of one rank on the card
    in this process, (b) MESH_RANKS gloo ranks sharing the card. Returns
    ({kernel: {"a": launches, "b": [launches of each rank]}}, numbers)."""
    ref, launches_a, rates = mesh_world_of_one(card, counters)
    launches_b, numbers = mesh_ranks_sharing_the_card(card, ref)
    out = {k: {"a": 0, "b": [0] * MESH_RANKS} for k in counters}
    for path, n in launches_a.items():
        for k, v in n.items():
            out[k]["a"] += v
    for path, n in launches_b.items():
        k = path.split()[0]
        if k in out:
            out[k]["b"] = [x + y for x, y in zip(out[k]["b"], n)]
    numbers["rates_a"] = {k: max(v) for k, v in rates.items()}
    return out, numbers


def load_dossier():
    """``scripts/torch_validate_hw.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_validate_hw", os.path.join(REPO, "scripts",
                                          "torch_validate_hw.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tools_dossier():
    """(a) The dossier twin's sections at its --quick sizes, the 1024^2
    fade panel left to the full run; fails on a FAIL row or a kernel it did
    not launch. Returns its numbers."""
    dossier = load_dossier()
    d = dossier.Dossier(DEVICE)
    secs = d.run_sections(**dossier.sizes(quick=True), fade_big=False)
    rc = d.summary(secs)
    npass, total = d.checks()
    idle = [k for k, v in d.launches.items() if v == 0]
    print(f"dossier --quick: {npass}/{total} rows passed in {secs:.1f} s; "
          "kernel launches " + ", ".join(f"{k} {v}"
                                         for k, v in d.launches.items()))
    if rc:
        fail(f"the dossier failed {total - npass} of its {total} rows")
    if idle:
        fail(f"the dossier launched no {', '.join(idle)}")
    return {"rows_passed": npass, "rows": total, "seconds": secs,
            "launches": d.launches}


def tools_trace():
    """(b) ``utils.profiling.trace`` around one warm 256^2 K2 run inside an
    ``annotate`` region: the trace file names the region and K2's two
    passes. Returns (seconds of the traced run, trace bytes)."""
    from fast_tpu_torch import Fast
    from fast_tpu_torch.utils.profiling import annotate, trace
    region = "chip_smoke.k2_run"
    sim = Fast(flagship(), device=DEVICE)
    sim.run()
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            with annotate(region):
                _, secs = timed_run(sim)
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(files) != 1:
            fail(f"trace() wrote {files}, not one trace file")
        with open(files[0]) as f:
            text = f.read()
    names = {e.get("name", "") for e in json.loads(text)["traceEvents"]}
    missing = [w for w in (region, "synth_pass1", "detect_pass")
               if not any(w in n for n in names)]
    print(f"trace of one warm 256^2 K2 run ({secs:.3f} s, {sim.Niter} "
          f"realizations): {len(text)} bytes, {len(names)} event names; "
          f"region and K2's passes named: {not missing}")
    if missing:
        fail(f"the trace does not name {missing}")
    return secs, len(text)


def tools_cache():
    """(c) The factor tables' disk cache at 1024^2 with the 4 m pupil, in
    a temporary directory with the cache on. The card's float32 init
    builds its factors and leaves the directory empty (the card's build
    is not cached); the save and load of its stack, timed alone, give
    what a cached card build would cost. The host's float64 build (a
    float64 run of ``'colfac'``): an init that builds and saves, one that
    loads; the loaded L and its ``run()`` bit for bit the saving init's.
    Returns the seconds."""
    from fast_tpu_torch import Fast
    from fast_tpu_torch.utils import diskcache
    seconds = {"save": [], "load": []}

    def timed_call(fn, what):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            seconds[what].append(time.perf_counter() - t0)
            return out
        return call

    def init(p):
        t0 = time.perf_counter()
        sim = Fast(p, device=DEVICE)
        return sim, time.perf_counter() - t0

    save, load = diskcache.save, diskcache.load
    env = {k: os.environ.get(k) for k in ("FAST_TPU_TABLE_CACHE",
                                          "FAST_TPU_CACHE_DIR")}
    p32 = flagship(SYNTH="pallas_colfac", NITER=NITER_CACHE, NCHUNKS=1,
                   **WIDE)
    p64 = flagship(SYNTH="colfac", DTYPE="float64", NITER=NITER_CACHE_64,
                   NCHUNKS=1, **WIDE)
    with tempfile.TemporaryDirectory() as cdir:
        os.environ.update(FAST_TPU_TABLE_CACHE="1", FAST_TPU_CACHE_DIR=cdir)
        diskcache.save = timed_call(save, "save")
        diskcache.load = timed_call(load, "load")
        try:
            card, t_card = init(p32)
            card_files = os.listdir(cdir)
            card_calls = len(seconds["save"]) + len(seconds["load"])
            t_card_build = card.timings["column_factors"]
            L32 = card.tables["L"].cpu().numpy()
            del card
            key = diskcache.table_key("torch-colfac-f32-timing", (L32,))
            diskcache.save(key, L32)
            same_32 = np.array_equal(diskcache.load(key), L32)
            t_save32, t_load32 = seconds["save"].pop(), seconds["load"].pop()
            os.remove(os.path.join(cdir, key + ".npy"))
            del L32
            built, t_built = init(p64)
            loaded, t_loaded = init(p64)
            nbytes = sum(os.path.getsize(f) for f in
                         glob.glob(os.path.join(cdir, "*.npy")))
        finally:
            diskcache.save, diskcache.load = save, load
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    same_L = torch.equal(built.tables["L"], loaded.tables["L"])
    r_b, r_l = series(built.run()), series(loaded.run())
    same_run = np.array_equal(r_b, r_l)
    out = {"card_f32_init": t_card,
           "card_f32_build": t_card_build,
           "card_f32_save": t_save32, "card_f32_load": t_load32,
           "host_f64_init_build_and_save": t_built,
           "host_f64_build_and_save": built.timings["column_factors"],
           "host_f64_save": seconds["save"][0] if seconds["save"] else None,
           "host_f64_init_with_load": t_loaded,
           "host_f64_load": seconds["load"][-1] if seconds["load"] else None,
           "host_f64_bytes": nbytes}
    del built, loaded
    print(f"disk cache at 1024^2 with the 4 m pupil: the "
          f"card's float32 init {t_card:.3f} s, its factor build "
          f"{out['card_f32_build']:.3f} s, nothing cached ({card_files}); "
          f"its stack saved alone in {t_save32:.3f} s, loaded in "
          f"{t_load32:.3f} s (bit for bit: {same_32}); the host's float64 "
          f"build: init {t_built:.3f} s (factor stage "
          f"{out['host_f64_build_and_save']:.3f} s, of which the save "
          f"{out['host_f64_save'] or 0:.3f} s for {nbytes / 1e9:.2f} GB), "
          f"init with the load {t_loaded:.3f} s (load "
          f"{out['host_f64_load'] or 0:.3f} s); loaded L bit for bit: "
          f"{same_L}; run() bit for bit: {same_run}")
    if card_files or card_calls:
        fail(f"the card's float32 init used the disk cache ({card_calls} "
             f"calls, {card_files})")
    if len(seconds["save"]) != 1 or len(seconds["load"]) != 2 or not nbytes:
        fail(f"the float64 inits saved {len(seconds['save'])} and loaded "
             f"{len(seconds['load'])} times ({nbytes} bytes on disk)")
    if not (same_32 and same_L and same_run):
        fail("a loaded factor stack or its run differs from the built one")
    return out


def tools_examples():
    """(d) The seven example twins at their written sizes on the card,
    started together: each must exit 0 and print its JAX example's column
    headers. Returns the seconds."""
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in EXAMPLES:
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(REPO, "examples",
                                              f"torch_{name}.py")],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        outs = {name: p.communicate(timeout=EXAMPLE_TIMEOUT)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for name, (out, err) in outs.items():
        print(f"--- examples/torch_{name}.py (exit {procs[name].returncode})")
        print(out.rstrip())
        if procs[name].returncode:
            print(err[-4000:], file=sys.stderr)
            fail(f"examples/torch_{name}.py exited "
                 f"{procs[name].returncode}")
        missing = [h for h in EXAMPLES[name] if h not in out]
        if missing:
            fail(f"examples/torch_{name}.py did not print {missing}")
    print(f"the seven example twins ran in {secs:.1f} s together")
    return secs


def phase_tools(card):
    """The tooling slice: (a) the dossier twin at --quick sizes, (b) a
    profiler trace, (c) the disk cache at 1024^2, (d) the example twins.
    Returns the result line's "tools" object."""
    t = {}
    t0 = time.perf_counter()
    dossier = tools_dossier()
    t["dossier"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace_run, trace_bytes = tools_trace()
    t["trace"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cache = tools_cache()
    t["cache"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t["examples"] = tools_examples()
    print(f"tools phase: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f" ({card})")
    return {"rows_passed": dossier["rows_passed"], "rows": dossier["rows"],
            "dossier_launches": dossier["launches"],
            "trace_run_s": trace_run, "trace_bytes": trace_bytes,
            "cache_s": cache, "seconds": t}


def rates(runs, card, where, unit="realizations"):
    """Warm ``run()`` rates of the named sims, two each, in the given
    order; prints and returns {name: [per second, ...]}."""
    out = {}
    for name, sim in runs:
        out.setdefault(name, []).append(sim.Niter / timed_run(sim)[1])
    for name, v in out.items():
        print(f"rate {where}: {name}: " + ", ".join(f"{r:.0f}" for r in v)
              + f" {unit}/s (warm run() of {dict(runs)[name].Niter};"
              f" {card})")
    return out


def phase_slices():
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    K1, K2 = cd.colfac_detect, sd.synth_detect

    sim_k = Fast(flagship(), device=DEVICE)
    sim_d = Fast(default_config(), device=DEVICE)
    for sim in (sim_k, sim_d):
        if sim._synth != "pallas_fused":
            fail(f"SYNTH='auto' resolved to {sim._synth!r}, not pallas_fused")
    t0 = time.perf_counter()
    sim_c = Fast(flagship(NPXLS=512), device=DEVICE)
    init_512 = time.perf_counter() - t0
    if sim_c._synth != "pallas_colfac":
        fail(f"SYNTH='auto' at 512^2 resolved to {sim_c._synth!r}")
    print(f"512^2 flagship: Fast() in {init_512:.2f} s, column factors "
          f"{sim_c.timings['column_factors']:.3f} s (first, float32 on the "
          f"card), P={sim_c.Npxls_pup}")
    k2 = phase_k2(sim_k, sim_d)
    k1 = phase_k1(sim_c)

    # 256^2: the K2 path
    r_k, k2["launches"], _ = slice_run(sim_k, "K2", K2, K1, "slice 256^2")
    SERIES["K2"] = r_k
    sim_p = Fast(flagship(SYNTH="matmul"), device=DEVICE)
    r_p = series(timed_run(sim_p)[0])
    agree(r_k, r_p, "slice 256^2", "K2")
    r_d = slice_run(sim_d, "K2", K2, K1, "default config")[0]
    agree(r_d, series(Fast(default_config(SYNTH="matmul"),
                           device=DEVICE).run()),
          f"default config {sim_d.Npxls}^2, P={sim_d.Npxls_pup}", "K2")

    # 512^2: the K1 path
    r_c, k1["launches"], _ = slice_run(sim_c, "K1", K1, K2, "slice 512^2")
    SERIES["K1"] = r_c
    sim_cm = Fast(flagship(NPXLS=512, SYNTH="matmul", NITER=NITER_SMALL,
                           NCHUNKS=16), device=DEVICE)
    agree(r_c, series(timed_run(sim_cm)[0]), "slice 512^2", "K1")

    # subharmonics through both kernels
    for npx, kernel, ctr, other, niter in ((256, "K2", K2, K1, NITER),
                                           (512, "K1", K1, K2, NITER_SMALL)):
        kw = dict(NPXLS=npx, SUBHARM=True, NITER=niter, SEED=5)
        sim_s = Fast(flagship(**kw), device=DEVICE)
        r_s = slice_run(sim_s, kernel, ctr, other,
                        f"SUBHARM {npx}^2")[0]
        r_sm = series(Fast(flagship(SYNTH="matmul", **kw),
                           device=DEVICE).run())
        agree(r_s, r_sm, f"SUBHARM {npx}^2", kernel)

    return dict(k2=k2, k1=k1, sim_k=sim_k, sim_p=sim_p, sim_c=sim_c,
                sim_cm=sim_cm, r_iid=r_p)


def phase_times(card, ctx, tsims):
    """Warm ``run()`` rates, interleaved, and the profiles; launches here
    do not count."""
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    sim_k, sim_p = ctx["sim_k"], ctx["sim_p"]
    sim_c, sim_cm = ctx["sim_c"], ctx["sim_cm"]
    sim_g = Fast(flagship(MC_NOISE="gauss"), device=DEVICE)
    sim_k1 = Fast(flagship(SYNTH="pallas_colfac"), device=DEVICE)
    for sim in (sim_g, sim_k1):
        timed_run(sim)
    rates_256 = rates([("K2", sim_k), ("matmul", sim_p),
                       ("K1 pinned", sim_k1), ("K2 gauss", sim_g),
                       ("K2 gauss", sim_g), ("K1 pinned", sim_k1),
                       ("matmul", sim_p), ("K2", sim_k)], card, "256^2")
    sim_cc = Fast(flagship(NPXLS=512, SYNTH="colfac"), device=DEVICE)
    print(f"512^2 column factors, second build: "
          f"{sim_cc.timings['column_factors']:.3f} s (float32 on the card)")
    sim_c2 = Fast(flagship(NPXLS=512, SYNTH="pallas_fused",
                           NITER=NITER_K2_512), device=DEVICE)
    for sim in (sim_cc, sim_c2):
        timed_run(sim)
    rates_512 = rates([("K1", sim_c), ("colfac", sim_cc), ("matmul", sim_cm),
                       ("K2 pinned", sim_c2), ("K2 pinned", sim_c2),
                       ("matmul", sim_cm), ("colfac", sim_cc), ("K1", sim_c)],
                      card, "512^2")
    sim_t, sim_t16, sim_tf = tsims
    timed_run(sim_tf)
    rates_t = rates([("K4", sim_t), ("fft route", sim_tf), ("K5", sim_t16),
                     ("K5", sim_t16), ("fft route", sim_tf), ("K4", sim_t)],
                    card, "temporal", "steps")
    profile([("K2 256^2", sim_k), ("K1 512^2", sim_c),
             ("colfac 512^2", sim_cc), ("matmul 512^2", sim_cm),
             ("K4 temporal 256^2", sim_t),
             ("K5 temporal 512^2, 16 layers", sim_t16)])
    for fn in (cd.colfac_detect, sd.synth_detect, af.ar_flow_fused,
               af.ar_flow_streamed):
        fn.LAUNCHES = 0
    return rates_256, rates_512, rates_t


def _short(name):
    m = re.search(r"(synth_pass1|colfac_pass1|split_pass1|detect_pass|"
                  r"screens_pass|sum_tiles|ar_update|ar_dft|ar_detect)", name)
    return m.group(1) if m else name[:48]


def profile(runs):
    """One warm ``run()`` of each named sim under ``torch.profiler``:
    wall, device busy share, peak device memory and the largest device
    items by name."""
    from fast_tpu_torch.utils.profiling import device_breakdown
    for name, sim in runs:
        torch.cuda.reset_peak_memory_stats()
        wall, busy, per = device_breakdown(sim.run)
        peak = torch.cuda.max_memory_allocated() / 1e9
        top = "; ".join(f"{_short(k)} {v * 1e3:.1f} ms ({v / busy:.1%})"
                        for k, v in list(per.items())[:4])
        print(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy * 1e3:.1f} ms ({busy / wall:.1%}), peak {peak:.2f} GB;"
              f" {top}")


def kernel_entry(name, source, replaces, res, shape, run_rates, timed):
    """One kernel's entry of the result line: the contract's keys, then
    what else was measured and the run rates. No single PyTorch call
    computes any of these functions, so there is no library time."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **{k: res[k] for k in keys},
            "library_ms": None, "shape": shape, **timed,
            **{k: v for k, v in res.items() if k not in keys},
            "run_rates": {k: max(v) for k, v in run_rates.items()}}


def main():
    t_start = time.perf_counter()
    # every phase but the disk cache's builds its tables cold
    os.environ["FAST_TPU_TABLE_CACHE"] = "0"
    card = phase_env()
    phase_build()
    ctx = phase_slices()
    k4, k5, tsims = phase_temporal(ctx)
    rates_256, rates_512, rates_t = phase_times(card, ctx, tsims)
    # the temporal flagship's K4 series of its last warm run, for the fades
    from fast_tpu_torch import comms
    fade_series = torch.as_tensor(comms._result_series(tsims[0].result),
                                  device=DEVICE)
    fade_dt = tsims[0].dt
    del ctx["sim_k"], ctx["sim_p"], ctx["sim_c"], ctx["sim_cm"], tsims
    torch.cuda.empty_cache()
    k2w, k3, k7, rates_w = phase_wide(card)
    ctx["k2"].update({f"{k}_1024": v for k, v in k2w.items()
                      if k != "launches_wide"},
                     launches_1024=k2w["launches_wide"])
    torch.cuda.empty_cache()
    from fast_tpu_torch.ops import kernel_wrappers
    counters = kernel_wrappers()
    k6, rates_oi, rates_ot, ctx["k2"]["launches_orbit"] = phase_orbit(
        card, counters)
    phase_wide_ar(card, counters, k4, k5, k6)
    dft = phase_ar_dft(card)
    k4.update(ar_dft=dft["ar_dft", 256], ar_dft_1024=dft["ar_dft", 1024],
              ar_detect=dft["ar_detect", 256],
              ar_detect_1024=dft["ar_detect", 1024])
    k5.update(ar_dft=dft["ar_dft", 512], ar_detect=dft["ar_detect", 512])
    k6.update(ar_dft=dft["ar_dft", 256], ar_detect=dft["ar_detect", 256])
    # before the mesh and tools phases, whose profiler sessions leave the
    # profiler without device records in this process
    phase_precision(card, {"K1": ctx["k1"], "K2": ctx["k2"], "K3": k3,
                           "K4": k4, "K5": k5, "K6": k6, "K7": k7})
    comms_res = phase_comms(card, fade_series, fade_dt)
    rates_256["FastFSOC 16-QAM (K2 + modem)"] = [comms_res["fsoc_rate"]]
    ctx["k2"]["launches_comms"] = comms_res.pop("launches")
    mesh_launches, mesh_res = phase_mesh(card, counters)
    tools = phase_tools(card)
    wide_shape = "1024^2, P=402"
    line = {"kernels": [
        kernel_entry("synth_detect", "fast_tpu_torch/csrc/synth_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:289", ctx["k2"],
                     "256^2, P=82, mixed", {**rates_256, **{
                         f"iid orbit pass {k}": v
                         for k, v in rates_oi.items()}},
                     {"timed_draws": NTIME}),
        kernel_entry("colfac_detect", "fast_tpu_torch/csrc/colfac_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:724", ctx["k1"],
                     "512^2, P=82, mixed", rates_512, {"timed_draws": NTIME}),
        kernel_entry("colfac_detect_split",
                     "fast_tpu_torch/csrc/colfac_split.cu",
                     "fast_tpu/ops/pallas_synth.py:531", k3,
                     wide_shape + ", mixed", rates_w, {"timed_draws": 630}),
        kernel_entry("ar_flow_fused", "fast_tpu_torch/csrc/ar_flow.cu",
                     "fast_tpu/ops/pallas_synth.py:996", k4,
                     "256^2, 4 layers, P=82, uniform", rates_t,
                     {"timed_steps": NTIME}),
        kernel_entry("ar_flow_streamed", "fast_tpu_torch/csrc/ar_flow.cu",
                     "fast_tpu/ops/pallas_synth.py:1736", k5,
                     "512^2, 16 layers, P=82, uniform", rates_t,
                     {"timed_steps": MAX_STEPS_K5}),
        kernel_entry("ar_flow_fused_batch", "fast_tpu_torch/csrc/ar_flow.cu",
                     "fast_tpu/ops/pallas_synth.py:1228", k6,
                     f"{NSAMP} series x 256^2, 4 layers, P=82, uniform",
                     rates_ot, {"timed_steps": 256}),
        kernel_entry("synth_screens", "fast_tpu_torch/csrc/synth_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:175", k7,
                     wide_shape + ", Box-Muller", rates_w,
                     {"timed_draws": 630}),
    ], "comms": comms_res, "mesh": mesh_res, "tools": tools}
    names = {"synth_detect": "K2", "colfac_detect": "K1",
             "colfac_detect_split": "K3", "ar_flow_fused": "K4",
             "ar_flow_streamed": "K5", "ar_flow_fused_batch": "K6",
             "synth_screens": "K7"}
    for entry in line["kernels"]:
        entry["launches_mesh"] = mesh_launches[names[entry["name"]]]
    # each main path's launches by TF32 passes (one, three), by kernel
    line["launches_by_passes"] = MAIN_PASSES
    line["seconds"] = time.perf_counter() - t_start
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
