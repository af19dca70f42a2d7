#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (slate_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: n=16384, nb=512, float32
    python3 chip_smoke.py --n 2048   # a shorter main path

Phases, one JSON line each:

1. env     torch/CUDA versions and the card (nvidia-smi name, power limit);
2. build   nvcc builds every kernel source of slate_tpu_torch/csrc;
   sass    cuobjdump -sass of the herk_lower_update library: each float64
           instance must hold DMMA and each float32 one TF32 HMMA
           (their counts, with DFMA and FFMA, on this line);
3. kernel  each kernel against its plain PyTorch version on the card, at
           the main path's shapes and a few more, plus the failure
           contracts (NaN pivot for chol_tile at pivots 0, 300 and in
           the last CTA's last row block of b = 512, and in each of the
           other plan modes at b = 128 and 1024, zero column for
           lu_panel_base, whose lu, perm and info must be bitwise the
           plain version's, also where a pivot tie or a NaN lies in
           another row slab; tau = 0 on a zeroed column and NaN propagation
           for the QR panels, a NaN row and an Inf row of A for
           herk_lower_update, whose strict upper triangle of C must also
           stay bitwise unchanged, in place in strided views of both
           types too; every herk_lower_update row is also held entry by
           entry to a float64 product, which a 1×TF32 product must fail,
           and prints its tile plan, which must be the C launcher's)
           and a float64 Q·R reconstruction of the timed QR panels;
           the two leaf kernels without a Pallas counterpart:
           trtri_leaves (P1) at the main path's shapes, timed in f32 and
           f64: (256, 64, 64) (potri's leaves at n = 16384), one 64-row
           base, the 2 and 8 leaves of a 128 and a 512 diagonal block as
           strided views (also by device time per launch, behind a
           device-side sleep); transposed views of upper leaves,
           complex128 through a conjugate-transposed view, complex64,
           unit and non-unit, s = 1, 7, 33, junk in the strict upper
           triangles (X must not change) and zero diagonals at 0, 7, 8,
           20 and s − 1 (non-finite in the same places), and every s from
           1 to 64 in f32, f64 and complex128, entry by entry within
           LEAF_ENTRY_C·s·ε·(|X|·|L|·|X|)ᵢⱼ of the plain version;
           lu_nopiv_base (P2) at (64, 64) f32 and f64 and smaller (timed
           also by device time per launch of the in-place form and of
           torch.linalg.lu_factor), a zero pivot at step 20 (info = 21),
           a NaN (info 6), signed zeros, in place on strided and
           transposed views inside a larger matrix (entries outside
           unchanged), every s from 1 to 64 in f32 and f64
           (lu_nopiv_sweep), and two leaves of one matrix filling one info
           slot with their step offsets (the first bad leaf wins): info
           exact and every entry bit for bit the plain version's (NaN in
           the same places);
           lu_panel_batched (P3, one thread-block cluster per chunk, one
           launch per CALU tournament round) bit for bit its plain
           version (lu, perm and info) at the tournament's round shapes
           (32, 512, 512) and (16, 1024, 512) in f32 and f64 and the
           final round's (1, 1024, 512) f32 (timed by CUDA events and by
           device time per launch, beside the plain version and batched
           torch.linalg.lu_factor), on both sides of the boundary between
           resident and streaming CTAs ((1, 1744, 512) and (1, 1745, 512)
           f32), at one chunk, ragged heights and w < H, with a zero
           column in one chunk (info there, the other chunks bit for bit
           as without it), a NaN that must win its column's pivot, and
           exact pivot ties; each row prints its plan (CTAs per chunk,
           rows per CTA, mode, shared memory per CTA, which must equal
           the C launcher's);
           and at the batched engine's panels (1000, 256, 32) and
           (10000, 32, 32) f32, timed;
           chol_tile_batched (P4, one warp per item) bit for bit its plain
           version (L with NaN in the same places, info exact, zero strict
           upper triangles although 1e6 junk lies there) at the engine's
           tiles (the diagonal blocks of a (1000, 256, 256) stack as a
           strided view, and (10000, 32, 32)) in f32 (and the first in
           f64), timed by CUDA events and device time per launch beside
           its plain version and batched torch.linalg.cholesky_ex; with
           non-positive pivots at 0, 20 and s − 1 (info there, every
           other item bit for bit as without them), and every s from 1 to
           64 in f32 and f64 (chol_batched_sweep);
           qr_panel_batched (P5, one CTA per item, its plan resident or
           streaming) within qr_case's tolerance of its plain version per
           item, at the engine's panels ((1000, 512, 32) as a strided
           view, (10000, 64, 32), f64, streaming at (8, 2000, 128)), a
           float64 reconstruction of the timed rows' first and last items,
           tau = 0 on a zero column, a NaN kept to its item (its earlier
           columns finite, every other item bit for bit), timed beside its
           plain version and batched torch.geqrf; each row prints its plan,
           whose shared memory must equal the C launcher's;
           P1 also at the engine's leaves, (1000, 32, 32) unit blocks of a
           stack and (10000, 32, 32), timed;
           lu_panel_base, qr_panel_base and qr_panel_base_wide run as one
           cooperative launch over the SMs, with cases in both plan modes
           (row slabs resident in shared memory, and streamed: (65536,
           128) f32, (131072, 32) and (32768, 128) f64) and ragged slabs
           of a few rows; each row prints its plan (blocks, rows, mode);
           chol_tile runs as one thread-block cluster, with cases in each
           of its plan modes (one CTA holding the whole tile: b = 1, 33,
           128, 200 f32; 8 CTAs holding their row blocks: 512 f32; 8
           CTAs streaming: 1024 f32, 512 and 1024 f64); each row prints
           its plan (ctas, block_rows, mode, and the shared memory per
           CTA, which must equal the C launcher's);
           kernel, plain and library times by CUDA events (warm, median
           of 7; chol_tile at b = nb and 128 f32 and streaming at 1024
           f32 and 512 f64, qr_panel_base resident at (2n, 32) f32 and
           streaming at (131072, 32) f64), and for
           herk_lower_update the cuBLAS recursion too and its bound at
           the tensor cores' peaks beside the FMA peaks' one;
4. check   posv/gesv/gels on the card at small uneven sizes against
           float64 numpy; gels at nb = 32 runs qr_panel_base in every
           panel, at nb = 128 qr_panel_base_wide, and a wide operand runs
           the minimum-norm path through gelqf; trtri, trtrm, potri,
           getri, gesv_nopiv and gesv_rbt at n = 300 / 256 (nb = 64)
           against float64 numpy; gels by CholQR at
           (20000, 9000), nb = 128, whose 71-block-column Gram matrix
           takes potrf's recursion (herk_lower_update 7 times), against a
           float64 lstsq; tsqr; the BLAS-3 verbs and norm against float64
           torch; getrf with MethodLU.CALU at n = 300 (‖A[perm] − L·U‖
           scaled ≤ 30, 13 lu_panel_batched launches, no lu_panel_base),
           gesv with CALU and with pivot_threshold = 0.5 against float64
           numpy, and a singular operator whose CALU info must equal the
           CPU run's;
5. main    the serving path: a Session registers an SPD operator (chol),
           a general one (lu), a tall (2n × n/2) one (op "auto" must
           infer qr) and the SPD operator again at nb = n/128 (128 block
           columns: potrf's recursion, exactly 7 herk_lower_update and
           128 chol_tile launches at n = 16384), factors each once and
           serves 8 requests from each resident factor (single
           right-hand sides and 16-column blocks), every scaled residual
           checked; every served qr column is held to a float64
           normal-equations solve (relative error ≤ QR_REL_LIMIT), and a
           1 %-perturbed and a random answer must fail that check; a
           diagonally dominant operator registered with MethodLU.NoPiv
           (factored by getrf_nopiv: P2 leaves) serves 8 requests too, and
           so does the general operator registered again with
           MethodLU.CALU (getrf_tntpiv: exactly 161 lu_panel_batched and
           256 lu_nopiv_base launches and no lu_panel_base at n = 16384;
           its factor wall beside the lu factor's);
           then chol_inverse_using_factor and lu_inverse_using_factor on
           the resident chol and lu factors, each held to ‖I − A·X‖₁ /
           (n·ε·‖A‖₁·‖X‖₁) ≤ 30 in float64, and one lu_solve of the
           general operator with MethodLU.RBT under the residual gate,
           with its refinement steps and fallback printed. The P1, P2
           and P3 launches of every factor, solve and inverse are held to
           fixed numbers at n = 16384 and 2048 (nb = 512). Peak memory is read
           before the inverses and the float64 checks allocate.
   serve   the serving front end on the main phase's operands: a fresh
           Session with the chol, lu, qr (2n × n/2) and nb = n/128 chol
           operators under an Executor (max_batch 32, max_wait 2 ms);
           Executor.warmup factors each and captures its one-column solve
           as a CUDA graph (each warmup's wall, aot_compiles and graph
           bytes printed; its launches must be the main factor's plus two
           solves' P1 bases: the eager run before the capture and the
           capture); SERVE_CLIENTS client threads send 32 single-vector and
           2 16-column requests per operator each (host arrays, every
           result() under a timeout): every request completes, fewer
           batches than requests, every dispatch a graph replay that
           launches nothing, every served column under the residual gate
           (qr: within QR_REL_LIMIT of a float64 solve), request p50/p99
           per operator; a few served answers and 16 graph-replayed
           solves against eager *_solve_using_factor calls on the same
           resident factor, bit for bit (printed), and their times
           (p50/p99); a fault drill (the first SERVE_DRILL_FAULTS
           dispatches fail: retries, breaker trip, per-request rung;
           completed + failed = submitted); then 1000 lu_small and 1000
           chol_small operators at n = 256 (k = 2) served through an
           Executor by 4 threads, one singular lu_small operator failing
           alone with its info, requests per second, batches, the gate,
           and grouped against per-request bits (printed, not required).
6. small   the batched small-problem engine at both ends of the
           reference's bench_batched (float32, 2 right-hand sides):
           gesv/posv_batched at (n, B) = (256, 1000) and (32, 10000),
           gels_batched at (2n, n) for the same; each call's wall and
           requests per second, its kernel launches held to
           SMALL_LAUNCHES, every item under its gate (scaled residual ≤ 30
           in float64; gels within QR_REL_LIMIT of a float64 solve), a
           torch.linalg call for the same function timed beside it, and 64
           items served one at a time (their wall, gate, and whether each
           equals its batched lane bit for bit, with 2 right-hand sides and
           with a vector); then a Session with 1000 lu_small and one with
           1000 chol_small operators at n = 256: one solve_small_batched
           with every factor a miss, again with every factor resident, 8
           per-request solves (grouped against per-request bits printed),
           the counters, every answer under the gate; and each again with
           one bad operator (a zero column, a non-positive pivot) among
           the same ones: info on that item only, every other answer bit
           for bit as without it.
7. complex the complex64 and complex128 LU, Cholesky and QR paths
           (complex_phase): a Session with complex64 Hermitian positive
           definite (chol), general (lu) and tall (2n × n/2, qr)
           operators at n, nb (16384, 512 by default) beside
           torch.linalg.cholesky, lu_factor and torch.geqrf on the same
           operators (factor times and GFLOP/s by LAWN 41's complex
           counts, 4n³/3, 8n³/3 and 4·(2mn² − 2n³/3)), complex128 chol,
           lu and (8192 × 2048) qr operators and complex64 and
           complex128 CALU ones at n = 4096, a diagonally dominant
           complex64 NoPiv one, 8 requests each, every served column
           under the residual gate in complex128 (qr: within
           QR_REL_LIMIT of a complex128 solve), potri/getri of the
           complex128 factors, complex gels at nb = 32 (K3) in both
           types and a wide one by LQ, each against a complex128 solve;
           the factors launch the complex instances of K1, K2, K3, K4,
           P2, P3 and P1 and no K5 or P5;
   complex_small  the small phase's gesv/posv/gels_batched and Sessions
           in complex64, and gesv/posv/gels_batched at (32, 10000) in
           complex128 (P3, P4 and P5's complex instances).
8. mixed   mixed-precision refinement (mixed_phase): one Session with
           refined operators at n, nb — an f32 SPD chol and an f32
           diagonally dominant lu from bf16 factors, an f64 SPD chol and
           an f64 Gaussian lu from f32 factors, the f32 SPD one again at
           nb = n/128 (a bf16 potrf through the recursion: its bf16 K5
           launches held to REC_POTRF_LAUNCHES), complex128 chol and lu
           from complex64 factors at n = 4096 — each with its κ₁, its
           low-precision factor's wall, resident bytes and launches by
           type beside the unrefined working-precision factor's wall and
           bytes, Executor.warmup (wall, the two captured graphs, their
           bytes), 8 requests (vectors and 16-column blocks) with their
           iterations and p50/p99, every served column under the gate in
           float64 (complex128), and the replayed refined solves against
           the eager refine-engine drive on the same resident, bit for
           bit; an f32 Gaussian lu from a bf16 factor, which IR must not
           converge on (the counted fallback, answer gated), and the same
           operator under GMRES-IR (converged or not, iterations); a fault
           drill (refine_no_converge: the counted fallback; a breaker trip
           on a mixed bucket: the working_precision rung, one demotion,
           later solves unrefined); gesv/posv_mixed_batched at (256, 1000)
           and (32, 10000), f32 ← bf16 and f64 ← f32, 2 right-hand sides
           (wall, requests per second, launches by type, every item under
           the gate, the iteration histogram, the plain batched verb
           timed beside); and 1000 refined lu_small operators at n = 256
           through solve_small_batched, cold and warm (counters, gate,
           grouped against per-request bits printed, not required).
9. update  incremental updates (update_phase): a chol operator at n, nb
           (f32, warmup(nrhs=16, update_k=16)) updated at k = 1, 3 and 16,
           downdated to undo the k = 3 update, hit by an injected
           update_abort (a counted refactor; the resident's factor bits
           untouched) and by a downdate made indefinite on purpose (a
           counted refactor with reason downdate_indefinite; the next solve
           refused): after each step 16 columns served by the warmed graph
           under the residual gate against A' in float64, bit for bit the
           eager chol_solve_using_factor on the updated resident, with
           factors_total, aot_compiles and the factor's storage unchanged
           on the happy path; each update's wall beside the abort's
           refactor wall; a 2n × n/2 qr operator (warmup(nrhs=16,
           update_k=16): append slots and the appended solve's graph) with
           16 appended rows, one appended row deleted and then a base row
           deleted (a counted refactor), every served column within
           QR_REL_LIMIT of a float64 normal-equations solve of the mutated
           operand, the appended solves replayed bit for bit the eager
           appended_gels with factors_total and aot_compiles unchanged,
           and the replayed 16-column solve timed by CUDA events (median
           of 5) before the append and after it;
           UPDATE_SMALL_OPS chol_small operators at n = 256 updated at
           k = 2 by one update_small_batched (wall) and as many B = 1
           Session.update calls on a second Session (wall), each item's
           factor bit for bit its B = 1 one and every item under the gate;
           and a bf16-refined chol operator at n updated at k = 16 (its
           operand moves to the Session's storage, so its two refine graphs
           are captured again, counted) with 16 refined columns under the
           float32 gate.
10. eig   the Hermitian eigensolvers (eig_phase), every operator
           Q·diag(λ)·Qᴴ with λ uniform in [−1, 1] and the Gaussian whose QR
           gives Q drawn by numpy from the seed. First stedc alone at
           n = STEDC_N in float64 on its three arms (STEDC_KINDS: a
           Gaussian tridiagonal, glued Wilkinson W21⁺ blocks joined by
           1e-9, d = 1 with e = 1e-12): its wall, P9's launches (on the
           Gaussian one also P9's device ms over them, by torch.profiler
           on one more run) and
           scipy.linalg.eigh_tridiagonal's wall on the same (d, e), the
           eigenvalues within n·STEDC_VALUE_C·max(1, |w|) of scipy's,
           ‖ZᵀZ − I‖max under n·STEDC_ORTH_C and ‖T·Z − Z·Λ‖max under
           n·STEDC_RES_C·max(1, |w|) (tests/test_stedc.py's torture
           bounds). Then heev with MethodEig.QR and vectors at
           n = EIG_VEC_N (the host steqr with vectors takes about 50 s at
           4096 on the H100 machine's 8-CPU host, so QR's vectors run at
           2048), nb = EIG_NB in float64, through he2td and through
           two_stage (he2hb + hb2td's chase); DC with vectors in float32
           and Auto in float64 at EIG_VEC_N (= Auto's stedc threshold:
           Auto must run stedc); MethodEig.DC through two_stage in float64
           and the same two QR paths in float32, complex128 and complex64
           at EIG_REPEAT_N (the same host steqr as float64's);
           complex128 and complex64 at EIG_COMPLEX_N through he2td under
           DC; Auto (he2hb + a dense eigh of the band) at the
           uneven EIG_AUTO_N; values only at EIG_VALUES_N (the steqr cap)
           in float32 under QR and under DC; QR at EIG_REDIRECT_N, above
           the cap, values only in float32, which must warn the
           reference's RuntimeWarning once and run stedc, not steqr; DC
           with vectors at EIG_N in float64; then hegv itype 1 under Auto at EIG_N in
           float64 (potrf: K1 and P1; hegst and the back-transform: P1;
           stedc: P9), its launches on its own, which must include K1, P1
           and P9. Each case prints its wall, GFLOP/s by the flop model,
           each stage's ms (CUDA events; steqr and stedc on the host clock
           ending in a sync) and torch.linalg.eigh's (values only:
           eigvalsh's) ms on the same operand; with vectors
           ‖A·Z − Z·Λ‖₁/(n·ε·‖A‖₁) and ‖ZᴴZ − I‖₁/(n·ε) must stay under
           EIG_GATE and the eigenvalues within EIG_VALUE_TOL·‖A‖ of numpy's
           float64 eigvalsh of the same matrix, values only within it of
           λ; hegv's residual ‖A·X − B·X·Λ‖₁/(‖A‖₁·n) under HEGV_TOL. The
           two sequential chains that could become port-only kernels are
           measured: he2td's latrd column (device events a column by the
           profiler at n = EIG_CHAIN_N, µs a column at full size, the
           columns' matrix-vector bytes bound) and hb2td's hop (events a
           hop at EIG_CHAIN_N, hops and µs a hop at full size); their
           profiled runs come after the heev launches are read and before
           hegv's are zeroed, so they are not counted. The line also
           gives the host's CPU count and torch's thread count (the host
           steqr's OpenMP threads).
11. svd   the SVD (svd_phase), every operator U·diag(σ)·Vᴴ with U and V
           from the float64 (complex128) QR of Gaussians drawn by numpy
           from the seed and σ geometric from 1 to 1/SVD_COND (the JAX
           package's svd_geo, cond = 100), rounded to the case's type:
           (a) Auto at SVD_N = 8192 square float32, nb = 1024 (the
           reference's own svd row; DC: ge2bd + bdsqr), values only and
           with vectors, beside torch.linalg.svdvals and
           torch.linalg.svd(full_matrices=False) on the same operand (one
           call each, cuSOLVER; yardsticks the port never calls); (b) the
           tall pre-QR arm at (32768, 4096) float32, nb = 512 (geqrf: K4;
           R by DC at 4096; unmqr), beside svdvals; (c) (4096, 1024)
           complex128, nb = 32, under MethodSVD.DC (geqrf: K3's complex128
           instance); (d) Auto at 2048 in complex64 and complex128; (e)
           the band arm (ge2tb, then hb2td and stedc on the Golub–Kahan
           embedding) at the uneven n = 1100 float64, nb = 256, values
           only and with vectors; (f) the dense band arm through the wide
           transpose at (700, 1000) float32, nb = 128; (g) rank 1536 of
           2048 float64 under DC (the σ ≈ 0 columns completed). Each case
           prints its wall, GFLOP/s by flops.svd, each stage's ms
           (svd_stage_timer), its seconds and, where ge2bd ran, µs a labrd
           column beside the bytes bound of its two matrix-vector
           products; σ must lie within SVD_VALUE_TOL·σ₁ of the known
           spectrum (zeros included), with vectors
           ‖A − U·Σ·Vᴴ‖₁/(‖A‖₁·max(m, n)·ε), ‖UᴴU − I‖₁/(m·ε) and
           ‖VᴴV − I‖₁/(n·ε) under SVD_GATE, and each arm must run its
           stages (through obs/stages.SVD_STAGES). P9, P1 and K4 must be
           launched in the phase, and K3 in complex128. The labrd chain's
           device events a column come from the profiler at
           SVD_CHAIN_N after the phase's launches are read.
12. spectral  the Session's eig and svd operators (spectral_phase) under
           one Session, seed 0, built as phases 10 and 11 build theirs
           (SPECTRAL_OPERATORS): Q·diag(λ)·Qᴴ at 4096 float64, nb = 512;
           U·diag(σ)·Vᴴ at 4096 × 2048 float64, nb = 512; an eig
           operator at 1024 complex128 and an svd operator at 1024 × 512
           complex64, nb = 128. Each factor (the staged two-stage
           pipeline: he2hb, hb2td, stedc, unmtr_hb2td, unmtr_he2hb, or
           ge2tb, the Golub–Kahan chase at 2·nb, stedc, unmtr_hb2td,
           unmbr_ge2tb) prints its wall, each stage's ms (CUDA events;
           stedc on the host clock ending in a sync), its P1 and P9
           launches, and the chase's hops and µs a hop; then warmup at 1
           and 16 columns (one CUDA graph per catalog function at the
           first, none at the second), resident and graph bytes, the
           spectrum within EIG_VALUE_TOL·‖A‖ or SVD_VALUE_TOL·σ₁ of the
           known one (Λ ascending, Σ descending), the resident's residual
           and orthogonality under EIG_GATE / SVD_GATE; then for every
           catalog function SPECTRAL_REQUESTS requests at 1 and at 16
           columns, each at a fresh θ (eig solve at midpoints of adjacent
           eigenvalues, truncate a rank in 1..k and one half-integer, svd
           solve θ = 0 then ridges, whiten and psd_project θ in [0, 0.5]):
           the replayed answer (Session.solve_matrix) bit for bit the
           eager apply's on the same resident, each within
           SPECTRAL_SERVED_TOL of L·diag(w)·Rᴴ·b in float64 from the
           resident's own tensors (in units of max(m, n)·ε·max|w|·‖b‖₂),
           eig solve's ‖(A − θI)·x − b‖∞/(n·ε·‖A − θI‖∞·‖x‖∞) under
           RESIDUAL_BOUND, no new capture and one graph replay per request
           (Session.apply once per function too), replayed and eager
           p50/p99 per function and width; then SPECTRAL_EXECUTOR default
           solves through an Executor on the float64 eig operator
           (completed = submitted, each dispatch a replay, each answer
           under the same gates). Its factors must launch P1 and P9.
           Beside them, after the launches are read: heev DC with vectors
           at 4096 float64 (the eig phase's row), svd under Auto at
           4096 × 2048 float64 (one call; the tall arm: geqrf, then DC on
           R), and torch.linalg.eigh and torch.linalg.svd at those shapes
           (one call each, cuSOLVER; yardsticks the port never calls).
The kernel phase also holds P9 (secular_roots, stedc's secular roots)
against its plain version at k = 4096, 512, 16384 and 64 (P9_KS) on a
Gaussian spectrum, a clustered one (half of δ 1e-9 to 2e-9 apart) and
one with every third z 1e-7 of the others (roots against their poles):
the roots δ[shift] + μ within SECULAR_ROOT_C·ε·max(max|δ|, ρ) (a flipped
pole choice is counted, not failed), the merge's eigenvectors built from
the kernel's (shift, μ) orthogonal to k·SECULAR_ORTH, and a second launch
equal to the first bit for bit; timed by CUDA events and device ms beside
the plain version's one call, its bound (61·k² pole terms at 3 float64
operations at the FMA rate) and torch.linalg.eigvalsh of the dense k × k
diag(δ) + ρ·z·zᵀ. Each row gives its plan (secular_roots_plan(k), which
must equal the built kernel's own plan_for), ptxas's registers and spill
stores for the instance it launches, and the ns a pole term of one
lane's chain (device ms / (62·⌈k/L⌉)) and per term and lane over the
card (device ms / (62·k·⌈k/L⌉)). The kernel's reciprocal is held to
IEEE division on 2²⁰ denominators over 1e-300 ≤ |den| ≤ 1e300 (its
largest error in ulps, printed; at most P9_RECIP_ULPS).
The kernel phase also holds the incremental-update kernels P6
(chol_update_sweep), P7 (qr_append_build) and P8 (qr_append_apply)
against their plain versions (UPDATE_TOL of max |plain|, bitwise
printed; on the H100 they have been bit for bit): at the update phase's
shapes in float32 (P6 on the dense n × n factor at kb = 16 and kb = 1 and
on a (1000, 256, 256) stack at kb = 2, untimed at P6_UNTIMED_N under the
same CTA plan at kb = 4 up and down and through the bfloat16 route; P7 on the qr operator's n/2 × n/2
R with 16 appended rows; P8 on its 16-column solve padded to 512
columns, also in float64 and, at P8_COMPLEX_NPAD = 4096 rows, complex64
and complex128), timed by CUDA
events beside the plain version's one call, the refactor it replaces
(torch.linalg.cholesky of A'; torch.geqrf of [R; U]; for P8 torch.ormqr
of its reflectors) and the bound (P8 also its chain bound, P + 4
dependent rounded operations a step, P + 7 in complex types, at
DEP_CYCLES and the top SM clock); P8 bit for bit its plain version,
its plan's shared memory the launcher's; P8 also at a ragged
(2048, 1999, 200, 16); at n = 2000 (2048 rows) in float32, float64,
complex64 and complex128 (P6 also a failed downdate: info equal, finite);
and P6's exact contracts (a zero update and bucket 4 against 8 bit for
bit, each lane of a stack bit for bit its B = 1 run). The kernel phase
also holds K5's bfloat16 instance against its plain
version (HERK_BF16_ULPS bfloat16 units of |C| + |A·Aᵀ| plus the float32
sums' difference, entry by entry; the strict upper triangle unchanged;
its plan the C launcher's) at 8192² × 1024 and 2048² × 512 (CUDA-event
and device times, its bound at the bf16 tensor rate, torch.addmm in
bf16), a strided view with an unaligned row stride and a NaN row, and
the bf16 routes of K1, K2, P1, P3 and P4 (their float32 instance on a
float32 copy, rounded back: K2, P3 and P4 bit for bit their plain
versions' route, K1 and P1 within one bfloat16 unit; the route's time
beside the float32 instance's, their difference the copies').
The kernel phase also holds the complex instances of K1-K4 and P2-P5
against their plain versions at the real rows' shapes (kernel lines
with "dtype": "complex"; K2, P2, P3 and P4 bit for bit, K1, K3, K4 and
P5 within their tolerances), with their fault cases (a negative real
pivot with an imaginary part, a zero column or pivot, a NaN, inf + nan·i,
ties in modulus; for the Householder kernels a zero column (tau = 0,
alpha kept), zero tails under an alpha with an imaginary part (tau ≠ 0)
and a NaN), K4 at (10000, 128) complex128, which streams, and a
"spills" line gives ptxas's registers and spill stores for every complex
instance and every instance of P6, P7 and P8.

The kernels' launch counters are zeroed just before the check phase,
the main phase, the serve phase, the small phase, the complex phase, the
complex_small phase, the mixed phase, the update phase, the eig phase
(and its hegv), the svd phase and the spectral phase and read just after
each (also by element type:
each kernel's "dtypes" and "launches_by_dtype" in the kernels line);
the launches made to compare a kernel with its plain version are not
counted.
Then a {"kernels": [...]} line (for each kernel also its plan, which is
derived from the shape, the type and the SM count the run queried, not
measured; for chol_tile also its numbers at b = 128 under "at_b128",
for herk_lower_update at 2048² float64 under "at_f64_2048", for
lu_panel_batched at (16, 1024, 512) and (1, 1024, 512) f32 under
"at_16x1024x512" and "at_1x1024x512", and at the engine's shapes; P1,
P4 and P5 at the engine's other shapes under "at_..."; the complex
instances of K1-K4 and P2-P5 under "at_complex64_..." and
"at_complex128_..."; P6-P8 with their update-phase launches, whether
they equal their plain versions bit for bit, and their other rows
under "at_..."; P9 with its eig-, svd- and spectral-phase launches (P1
and P9 also the spectral phase's alone, "spectral_launches"), its k = 4096 Gaussian
row and its other rows under "at_k<k>_<spectrum>"), the nvidia-smi line,
and last
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without a CUDA device, or
without the slate_tpu_torch package beside this file, it exits 2 at once.
This script imports nothing of JAX and nothing of slate_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 3.35 TB/s; FP32 67
# TFLOP/s and FP64 34 TFLOP/s outside the tensor cores (FMA_FLOPS); FP64
# 67 TFLOP/s on them (DMMA). A bound takes the type's top rate, so that
# no kernel's bound is laxer than the card allows
PEAK_BYTES_PER_S = 3.35e12
FMA_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12,
              "complex64": 67e12, "complex128": 67e12}
# herk_lower_update runs on the tensor cores: TF32 495 TFLOP/s (same data
# sheet), of which 3×TF32 gets a third
HERK_PEAK_FLOPS = {**PEAK_FLOPS, "float32": 495e12 / 3}
# device_ms's sleep: about 10 ms at the H100's clocks, longer than the
# host takes to queue 50 small launches
SLEEP_CYCLES = 20_000_000
RESIDUAL_BOUND = 30.0
# served least-squares columns against a float64 solve, as gels_check
QR_REL_LIMIT = 1e-3


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn()`` in ms by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, launches: int = 50, must_queue: bool = True):
    """Device time per launch of ``fn()`` in ms, by CUDA events around
    ``launches`` calls queued behind a device-side sleep, so that the
    host's launch work is not in the time. The host must have queued every
    call before the sleep ends (else host gaps are in the time): the sleep
    is made four times longer up to twice, then the check fails (or, with
    ``must_queue`` False, None is returned)."""
    import torch
    fn()
    torch.cuda.synchronize()
    for cycles in (SLEEP_CYCLES, 4 * SLEEP_CYCLES, 16 * SLEEP_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / launches
    check(not must_queue, f"device_ms: the host took {host_ms} ms to queue "
          f"{launches} calls, longer than the sleep")
    return None


def library_device_ms(torch, fn, launches: int):
    """A library yardstick's device time per call and how it was taken:
    queued behind the sleep (``device_ms``) where the host can queue its
    calls, else ("profiler") the sum of its device events under
    torch.profiler over ``launches`` calls (a call that waits for the
    host inside, as a batched ``torch.geqrf`` does, cannot be queued)."""
    ms = device_ms(fn, launches, must_queue=False)
    if ms is not None:
        return ms, "sleep"
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    check(us > 0, "library_device_ms: the profiler saw no device time")
    return us / 1e3 / launches, "profiler"


def real_ops(flops: float, dtype: str) -> float:
    """The real operations of ``flops`` complex-or-real ones: a complex
    multiply-add is four real ones (LAWN 41's counts)."""
    return 4 * flops if dtype.startswith("complex") else flops


def bound(nbytes: float, flops: float, dtype: str, peaks=PEAK_FLOPS):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of the type (``flops``
    counted in the type's own operations, four real ones to a complex
    one)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = real_ops(flops, dtype) / peaks[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def wide(torch, x):
    """``x`` in float64, or complex128 if it is complex."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def spd_tile(torch, b, dtype, gen, junk_upper=True):
    """x·xᴴ/b + I; with ``junk_upper`` 1e6 junk in the strict upper
    triangle and, complex, 5i on the diagonal (K1 reads neither)."""
    x = torch.randn((b, b), generator=gen, device="cuda", dtype=dtype)
    a = x @ x.mH / b + torch.eye(b, device="cuda", dtype=dtype)
    if junk_upper:
        junk = torch.randn((b, b), generator=gen, device="cuda", dtype=dtype)
        a = torch.tril(a) + 1e6 * torch.triu(junk, 1)
        if a.is_complex():
            a.diagonal().add_(5j)
    return a.contiguous()


def chol_case(torch, ho, b, dtype, gen, timed: bool):
    a = spd_tile(torch, b, dtype, gen)
    lk = ho.chol_tile(a)
    lp = ho.chol_tile_plain(a)
    torch.cuda.synchronize()
    scale = lp.abs().max().item()
    err = (lk - lp).abs().max().item()
    tol = (1e-5 if dtype in (torch.float32, torch.complex64)
           else 1e-12) * scale
    check(math.isfinite(err) and err <= tol,
          f"chol_tile b={b} {dtype}: |kernel - plain| = {err} > {tol}")
    check(torch.count_nonzero(torch.triu(lk, 1)).item() == 0,
          f"chol_tile b={b}: nonzero above the diagonal")
    if a.is_complex():
        check(not lk.diagonal().imag.any(),
              f"chol_tile b={b} {dtype}: an imaginary part on the diagonal")
    row = {"b": b, "dtype": str(dtype).split(".")[1],
           "plan": chol_plan_row(ho, a), "max_abs_err": err, "tol": tol}
    if timed:
        row["ms"] = cuda_ms(lambda: ho.chol_tile(a))
        if a.is_complex():
            row["device_ms"] = device_ms(lambda: ho.chol_tile(a),
                                         launches=20)
        row["plain_ms"] = cuda_ms(lambda: ho.chol_tile_plain(a), reps=5)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(a))
        s = a.element_size()
        # reads the lower triangle, writes the whole tile
        row["bound_ms"], row["bound_by"] = bound(
            (b * (b + 1) // 2 + b * b) * s, b ** 3 / 3.0, row["dtype"])
    return row


def chol_plan_row(ho, a):
    """The cluster plan K1 launches with for ``a``; the plan's shared
    memory per CTA must be the launcher's."""
    b, s = a.shape[0], a.element_size()
    plan = ho.chol_tile_plan(b, s)
    smem = ho.chol_tile_smem_bytes(b, s, plan.ctas, plan.resident)
    launch_smem = ho.chol_tile_launch_smem(b, s, plan)
    check(smem == launch_smem, f"chol_tile b={b}: the plan counts {smem} "
          f"bytes of shared memory, the launcher {launch_smem}")
    return {"ctas": plan.ctas, "block_rows": plan.block_rows,
            "mode": plan.mode, "smem_bytes": smem}


def check_chol_modes(rows):
    """The kernel phase must run K1 as one CTA holding the whole tile, as
    a cluster holding its row blocks, and as a streaming cluster."""
    modes = {(r["plan"]["ctas"] > 1, r["plan"]["mode"]) for r in rows}
    check(modes == {(False, "resident"), (True, "resident"),
                    (True, "streaming")},
          f"chol_tile: the cases did not cover every plan mode: {modes}")


def chol_nan_case(torch, ho, gen, dtype=None, cases=None):
    """A negative pivot makes that diagonal entry NaN and every one after
    it, and leaves those before it finite: at b = 512 f32 (8 CTAs,
    resident) at pivots 0, 300 and in the last CTA's last row block; at
    b = 128 (one CTA) and b = 1024 (streaming) in a middle row block.
    Complex: the real part negative and 3i on that entry, at ``cases``."""
    dtype = dtype or torch.float32
    plan = ho.chol_tile_plan(512, 4)
    last_lo = plan.row_blocks(plan.ctas - 1, 512)[-1][0]
    cases = cases or [(512, 0), (512, 300), (512, last_lo + 20), (128, 70),
                      (1024, 700)]
    for b, bad in cases:
        a = spd_tile(torch, b, dtype, gen)
        a[bad, bad] = -a.abs().sum() + (3j if a.is_complex() else 0)
        for name, fn in (("kernel", ho.chol_tile),
                         ("plain", ho.chol_tile_plain)):
            d = fn(a).diagonal()
            check(bool(torch.isfinite(d[:bad]).all()) and
                  bool(torch.isnan(d[bad:]).all()),
                  f"chol_tile {name}: NaN contract broken at b = {b}, "
                  f"pivot {bad}")
    it = torch.empty((), dtype=dtype).element_size()
    return {"dtype": dtype_name(dtype),
            "bad_pivots": [{"b": b, "pivot": bad, "ctas": p.ctas,
                            "mode": p.mode}
                           for b, bad in cases
                           for p in [ho.chol_tile_plan(b, it)]],
            "nan_from_pivot_on": True}


def plan_row(ho, a, reserve):
    """The grid plan a panel kernel with ``reserve`` bytes of its own
    shared memory launches with for ``a``, the rows of the ragged last
    slab and the shared memory a block takes."""
    plan = ho.panel_plan_for(a, reserve)
    return {"blocks": plan.blocks, "rows": plan.rows, "mode": plan.mode,
            "last_rows": a.shape[0] - (plan.blocks - 1) * plan.rows,
            "smem_bytes": reserve + (plan.rows * a.shape[1]
                                     * a.element_size()
                                     if plan.resident else 0)}


def lu_case(torch, ho, hh, w, dtype, gen, timed: bool, zero_col=None):
    """K2 against its plain version: lu, perm and info bitwise equal."""
    a = torch.randn((hh, w), generator=gen, device="cuda", dtype=dtype)
    if zero_col is not None:
        a[:, zero_col] = 0
    lk, pk, ik = ho.lu_panel_base(a)
    lp, pp, ip = ho.lu_panel_base_plain(a)
    torch.cuda.synchronize()
    check(torch.equal(pk, pp), f"lu_panel_base {(hh, w)}: perm differs")
    check(int(ik) == int(ip), f"lu_panel_base {(hh, w)}: info {int(ik)} "
          f"!= {int(ip)}")
    if zero_col is not None:
        check(int(ik) == zero_col + 1, f"lu_panel_base: info {int(ik)} for "
              f"a zero column {zero_col}")
    err = (lk - lp).abs().max().item()
    check(torch.equal(lk, lp), f"lu_panel_base {(hh, w)} {dtype}: lu not "
          f"bitwise equal to the plain version (max |diff| {err})")
    row = {"H": hh, "w": w, "dtype": str(dtype).split(".")[1],
           "plan": plan_row(ho, a, ho.PANEL_SMEM_RESERVE),
           "max_abs_err": err, "bitwise_equal": True, "info": int(ik)}
    if timed:
        row["ms"] = cuda_ms(lambda: ho.lu_panel_base(a))
        if a.is_complex():
            row["device_ms"] = device_ms(lambda: ho.lu_panel_base(a),
                                         launches=20)
        row["plain_ms"] = cuda_ms(lambda: ho.lu_panel_base_plain(a), reps=5)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.lu_factor(a))
        s = a.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            2 * hh * w * s + 4 * hh + 4, hh * w * w - w ** 3 / 3.0,
            row["dtype"])
    return row


def check_plan_modes(name, rows):
    """The kernel phase must run a kernel in both plan modes, on a grid
    of more than one block, and with a ragged slab of a few rows."""
    plans = [r["plan"] for r in rows]
    check({p["mode"] for p in plans} == {"resident", "streaming"},
          f"{name}: the cases did not cover both plan modes: {plans}")
    check(plans[0]["blocks"] > 1, f"{name}: the main shape ran one block")
    check(min(p["last_rows"] for p in plans) < 16,
          f"{name}: no case has a slab of a few rows: {plans}")


def lu_edge_case(torch, ho, gen, dtype=None):
    """K2 where the pivot search crosses slabs: in column 0 the largest
    |a| ties between rows 33 and 70 (two slabs other than row 0's), so
    row 33 must win; a NaN at row 600 of column 5 (another slab than row
    5's) must win column 5 and set info = 6. lu, perm and info equal the
    plain version's (NaN where it has NaN, bitwise elsewhere). Complex:
    the tie is −3i against 3 (equal moduli), and the NaN is inf + nan·i,
    whose modulus is NaN, as the reference's jnp.abs gives it."""
    hh, w = 1000, 64
    dtype = dtype or torch.float32
    a = torch.randn((hh, w), generator=gen, device="cuda", dtype=dtype)
    a[:, 0] = (a[:, 0] / a[:, 0].abs().max() if a.is_complex()
               else a[:, 0].clamp(-1, 1))
    a[33, 0], a[70, 0] = (-3j if a.is_complex() else -3.0), 3.0
    a[600, 5] = complex(math.inf, math.nan) if a.is_complex() else math.nan
    lk, pk, ik = ho.lu_panel_base(a)
    lp, pp, ip = ho.lu_panel_base_plain(a)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(lk), torch.isnan(lp)
    check(torch.equal(pk, pp) and int(pk[0]) == 33 and int(pk[5]) == 600,
          f"lu_panel_base edge case: perm {pk[:6].tolist()} (plain "
          f"{pp[:6].tolist()})")
    check(int(ik) == int(ip) == 6, f"lu_panel_base edge case: info "
          f"{int(ik)}, plain {int(ip)}, expected 6")
    check(torch.equal(nan_k, nan_p) and torch.equal(lk[~nan_k], lp[~nan_p]),
          "lu_panel_base edge case: lu differs from the plain version")
    return {"H": hh, "w": w, "dtype": dtype_name(dtype),
            "plan": plan_row(ho, a, ho.PANEL_SMEM_RESERVE),
            "tie_rows": [33, 70],
            "pivot_0": int(pk[0]), "nan_at": [600, 5], "info": int(ik),
            "bitwise_equal_off_nan": True}


def qr_reconstruction(torch, a, vr, taus):
    """‖A − Q·R‖₁ / (H·ε·‖A‖₁) in float64 (complex128 for a complex panel)
    from the packed reflectors, ε of the panel's type."""
    hh, w = a.shape
    v = torch.tril(wide(torch, vr), -1)
    v.diagonal().fill_(1)
    qr = torch.zeros((hh, w), dtype=v.dtype, device=a.device)
    qr[:w] = torch.triu(wide(torch, vr)[:w])
    tw = wide(torch, taus)
    # Q·[R; 0] = H₀·…·H_{w−1}·[R; 0], H = I − τ·v·vᴴ
    for j in range(w - 1, -1, -1):
        qr -= tw[j] * torch.outer(v[:, j], v[:, j].conj() @ qr)
    a64 = wide(torch, a)
    norm1 = lambda x: x.abs().sum(dim=0).max().item()  # noqa: E731
    return norm1(a64 - qr) / (hh * torch.finfo(a.dtype).eps * norm1(a64))


def qr_case(torch, ho, hh, w, dtype, gen, timed: bool, zero_col=None):
    """K3 (w ≤ 32) or K4 (32 < w) against its plain version. Tolerance:
    the two differ only in the order of their H-long sums, so R is held
    to 4·ε·√H relative to max|R| and V (|v| ≤ 1) and the taus (in
    [0, 2]) to 4·ε·√H absolute."""
    wide = w > 32
    name = "qr_panel_base_wide" if wide else "qr_panel_base"
    kern = getattr(ho, name)
    plain = getattr(ho, name + "_plain")
    a = torch.randn((hh, w), generator=gen, device="cuda", dtype=dtype)
    if zero_col is not None:
        a[:, zero_col] = 0
    vk, tk = kern(a)
    vp, tp = plain(a)
    torch.cuda.synchronize()
    upper = torch.ones_like(vp, dtype=torch.bool).triu()
    tol = 4 * torch.finfo(dtype).eps * math.sqrt(hh)
    err_r = (torch.where(upper, vk - vp, 0).abs().max()
             / vp.abs().max()).item()
    err_v = torch.where(upper, 0, vk - vp).abs().max().item()
    err_t = (tk - tp).abs().max().item()
    check(tk.shape == (w,), f"{name} {(hh, w)}: taus shape {tuple(tk.shape)}")
    check(all(math.isfinite(e) and e <= tol for e in (err_r, err_v, err_t)),
          f"{name} {(hh, w)} {dtype}: |kernel - plain| R {err_r} V {err_v} "
          f"tau {err_t} > {tol}")
    if zero_col is not None:
        check(tk[zero_col].item() == 0 and tp[zero_col].item() == 0,
              f"{name}: tau {tk[zero_col].item()} on a zeroed column")
    row = {"H": hh, "w": w, "dtype": str(dtype).split(".")[1],
           "max_abs_err": max(err_v, err_t, err_r * vp.abs().max().item()),
           "err_r_rel": err_r, "err_v": err_v, "err_tau": err_t, "tol": tol}
    row["plan"] = plan_row(
        ho, a, ho.QR_PANEL_FIXED_ELEMS * a.element_size())
    if zero_col is not None:
        row["zero_col"] = zero_col
        row["tau_zero_col"] = abs(tk[zero_col].item())
    if timed:
        rec = qr_reconstruction(torch, a, vk, tk)
        check(rec <= RESIDUAL_BOUND, f"{name} {(hh, w)}: ‖A − QR‖ / "
              f"(H·ε·‖A‖) = {rec} > {RESIDUAL_BOUND}")
        row["reconstruction"] = rec
        row["ms"] = cuda_ms(lambda: kern(a))
        row["device_ms"] = device_ms(lambda: kern(a), launches=20)
        row["plain_ms"] = cuda_ms(lambda: plain(a), reps=5)
        row["library_ms"] = cuda_ms(lambda: torch.geqrf(a))
        s = a.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            2 * hh * w * s, 2.0 * hh * w * w - 2.0 * w ** 3 / 3.0,
            row["dtype"])
    return row


def qr_nan_case(torch, ho, gen, dtype=None):
    """A NaN in column 5 poisons that column's tau and every later one
    (no masking) in both QR kernels; the columns before stay finite.
    float32 unless ``dtype`` is given."""
    out = {}
    for name, w in (("qr_panel_base", 32), ("qr_panel_base_wide", 64)):
        a = torch.randn((1024, w), generator=gen, device="cuda",
                        dtype=dtype or torch.float32)
        a[50, 5] = math.nan
        vr, taus = getattr(ho, name)(a)
        check(bool(torch.isfinite(taus[:5]).all())
              and bool(torch.isnan(taus[5:]).all())
              and bool(torch.isfinite(vr[:, :5]).all()),
              f"{name}: NaN contract broken")
        out[name] = {"H": 1024, "w": w, "nan_at": [50, 5],
                     "nan_from_col_on": True}
    return out


def qr_zero_tail_case(torch, ho, gen, dtype):
    """Complex: an upper-triangular panel, so every column's tail is zero.
    Where the diagonal entry has an imaginary part the column is not
    degenerate (tau ≠ 0; R's diagonal real, beta = −sign(re α)·|α|);
    where it is real (column 3, set to 2.5) it is (tau = 0, alpha kept).
    K3 (1024, 32), K4 (1024, 64) and P5 (4, 256, 32), each also within
    8·ε of its plain version."""
    out = {}
    eps = torch.finfo(dtype).eps
    for name, shape in (("qr_panel_base", (1024, 32)),
                        ("qr_panel_base_wide", (1024, 64)),
                        ("qr_panel_batched", (4, 256, 32))):
        a = torch.randn(shape, generator=gen, device="cuda",
                        dtype=dtype).triu()
        a[..., 3, 3] = 2.5
        vk, tk = getattr(ho, name)(a)
        vp, tp = getattr(ho, name + "_plain")(a)
        d = a.diagonal(dim1=-2, dim2=-1)
        dk = vk.diagonal(dim1=-2, dim2=-1)
        live = torch.arange(shape[-1], device="cuda") != 3
        want = torch.where(d.real > 0, -d.abs(), d.abs())
        ok = (bool((tk[..., 3] == 0).all()) and bool((dk[..., 3] == 2.5).all())
              and bool((tk[..., live] != 0).all())
              and bool((dk.imag[..., live] == 0).all())
              and bool(((dk.real - want).abs()[..., live]
                        <= 8 * eps * d.abs()[..., live]).all()))
        err = max((vk - vp).abs().max().item(), (tk - tp).abs().max().item())
        check(ok and err <= 8 * eps * a.abs().max().item(),
              f"{name} {shape} {dtype}: zero-tail contract broken "
              f"(taus {tk[..., :5].tolist()}, |kernel − plain| {err})")
        out[name] = {"shape": list(shape), "degenerate_col": 3,
                     "taus_nonzero_elsewhere": True, "max_abs_err": err}
    return out


def tf32_rna(torch, x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, by masking its bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def herk_entry_ratio(torch, kern, ref, c0, a, keep=None):
    """The worst |kern − ref|ᵢⱼ / (ε·(|C| + |A|·|A|ᵀ)ᵢⱼ) over the lower
    triangle (and ``keep``), in float64, ε of the working type."""
    mask = torch.ones(kern.shape, dtype=torch.bool, device="cuda").tril()
    if keep is not None:
        mask &= keep
    a64 = a.double().abs()
    denom = torch.finfo(a.dtype).eps * (c0.double().abs() + a64 @ a64.mT)
    return ((kern.double() - ref.double()).abs() / denom)[mask].max().item()


def herk_plan_row(ho, c):
    """The tile plan K5 launches with for ``c``; the C launcher's plan
    must be the same, and the card must schedule at least the blocks per
    SM it bounds the registers for."""
    n, s = c.shape[0], c.element_size()
    plan = ho.herk_plan_for(c)
    launch_plan, resident = ho.herk_launch_plan(n, s)
    check(plan == launch_plan, f"herk_lower_update n={n}: the plan is "
          f"{plan}, the launcher's {launch_plan}")
    check(resident >= plan.blocks_per_sm, f"herk_lower_update n={n}: "
          f"{resident} resident blocks per SM for plan {plan}")
    return {**plan._asdict(), "pairs": plan.pairs(n),
            "resident_blocks_per_sm": resident}


def herk_case(torch, ho, blocked, n, k, dtype, gen, timed: bool,
              strided: bool = False, tf32_probe: bool = False):
    """K5 against its plain version. Tolerance: the two differ only in
    the order of their k-long sums (and, in float32, the 3×TF32 split),
    so the lower triangle is held to 4·ε·√k relative to
    max(|C| + |A|·|A|ᵀ); and entry by entry to ho.HERK_ENTRY_C·ε·(|C| +
    |A|·|A|ᵀ)ᵢⱼ against a float64 product (float32) or the plain version
    (float64); the strict upper triangle of C must be bitwise unchanged.
    ``strided``: C is the view big[h:, h:] and A = big[h:, :h] (h = k) of
    one (n + k)² tensor, as the recursive potrf hands them over, and
    nothing of big outside C's lower triangle may change.
    ``tf32_probe``: a 1×TF32 product of the same operands (A's mantissa
    rounded to TF32, then a float32 product) must fail the entrywise
    check."""
    if strided:
        big = torch.randn((n + k, n + k), generator=gen, device="cuda",
                          dtype=dtype)
        bk, bp = big.clone(), big.clone()
        ck, ak, cp, ap = bk[k:, k:], bk[k:, :k], bp[k:, k:], bp[k:, :k]
    else:
        c = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype)
        ak = ap = torch.randn((n, k), generator=gen, device="cuda",
                              dtype=dtype)
        ck, cp = c.clone(), c.clone()
    c0 = ck.clone()
    plan = herk_plan_row(ho, ck)
    out = ho.herk_lower_update(ck, ak)
    ho.herk_lower_update_plain(cp, ap, tile=plan["tile"])
    torch.cuda.synchronize()
    check(out.data_ptr() == ck.data_ptr(), "herk_lower_update: not in place")
    low = torch.ones((n, n), dtype=torch.bool, device="cuda").tril()
    scale = (c0.abs() + ak.abs() @ ak.abs().mT).max().item()
    err = (ck - cp)[low].abs().max().item()
    tol = 4 * torch.finfo(dtype).eps * math.sqrt(k)
    check(math.isfinite(err) and err <= tol * scale,
          f"herk_lower_update {(n, k)} {dtype}: |kernel - plain| = {err} > "
          f"{tol} * {scale}")
    ref = (cp if dtype == torch.float64
           else c0.double() - ak.double() @ ak.double().mT)
    entry = herk_entry_ratio(torch, ck, ref, c0, ak)
    check(math.isfinite(entry) and entry <= ho.HERK_ENTRY_C,
          f"herk_lower_update {(n, k)} {dtype}: entrywise error {entry}·ε "
          f"> {ho.HERK_ENTRY_C}·ε of (|C| + |A|·|A|ᵀ)ᵢⱼ")
    check(torch.equal(ck[~low], c0[~low]),
          f"herk_lower_update {(n, k)}: strict upper of C changed")
    if strided:
        keep = torch.ones_like(bk, dtype=torch.bool)
        keep[k:, k:] = ~low
        check(torch.equal(bk[keep], big[keep]),
              "herk_lower_update: wrote outside the lower triangle of the "
              "strided view")
    row = {"n": n, "k": k, "dtype": str(dtype).split(".")[1],
           "strided": strided, "plan": plan, "max_abs_err": err,
           "rel_err": err / scale, "tol": tol, "entry_ratio_max": entry,
           "entry_limit": ho.HERK_ENTRY_C, "upper_unchanged": True}
    if tf32_probe:
        t = tf32_rna(torch, ak)
        one = herk_entry_ratio(torch, c0 - t @ t.mT, ref, c0, ak)
        check(one > ho.HERK_ENTRY_C, f"herk_lower_update {(n, k)}: a 1×TF32 "
              f"product passes the entrywise check ({one}·ε)")
        row["tf32x1_entry_ratio_max"] = one
    if timed or n == k:  # the kernel at each square shape of the path
        work = c0.clone()
        row["ms"] = cuda_ms(lambda: ho.herk_lower_update(work, ak))
    if timed:
        c, a = c0, ak
        row["plain_ms"] = cuda_ms(
            lambda: ho.herk_lower_update_plain(work, a, tile=plan["tile"]),
            reps=5)
        row["recursion_ms"] = cuda_ms(lambda: blocked.herk_lower_rec(c, a, a))
        # the full product: twice the flops of the lower-triangle update
        row["library_ms"] = cuda_ms(lambda: torch.addmm(c, a, a.mT, alpha=-1))
        s = a.element_size()
        nbytes, flops = n * (n + 1) * s + n * k * s, float(n) * (n + 1) * k
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, row["dtype"],
                                                 HERK_PEAK_FLOPS)
        row["bound_fma_ms"] = bound(nbytes, flops, row["dtype"],
                                    FMA_FLOPS)[0]
    return row


def herk_nonfinite_case(torch, ho, gen, dtype, value, k):
    """A NaN or an Inf in row r of A makes row r and column r of the lower
    result non-finite (NaN for a NaN: all NaN) and leaves every other
    lower entry finite, within the entrywise check against a float64
    product, and the strict upper unchanged, in the kernel and in its
    plain version. Returns how many entries of that row and column each
    gives as NaN and as ±Inf."""
    n, r = 1000, 377
    c = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype)
    a = torch.randn((n, k), generator=gen, device="cuda", dtype=dtype)
    a[r, 5] = value
    low = torch.ones((n, n), dtype=torch.bool, device="cuda").tril()
    hit = torch.zeros_like(low)
    hit[r, :] = True
    hit[:, r] = True
    ref = c.double() - a.double() @ a.double().mT
    row = {"n": n, "k": k, "dtype": str(dtype).split(".")[1],
           "bad_row": r, "value": str(value)}
    for name, fn in (("kernel", ho.herk_lower_update),
                     ("plain", ho.herk_lower_update_plain)):
        out = fn(c.clone(), a)
        bad = out[low & hit]
        poisoned = (bool(torch.isnan(bad).all()) if math.isnan(value)
                    else not bool(torch.isfinite(bad).any()))
        check(poisoned and bool(torch.isfinite(out[low & ~hit]).all())
              and torch.equal(out[~low], c[~low]),
              f"herk_lower_update {name}: {value} contract broken at row "
              f"{r} ({dtype})")
        entry = herk_entry_ratio(torch, out, ref, c, a, keep=~hit)
        check(entry <= ho.HERK_ENTRY_C, f"herk_lower_update {name}: entrywise "
              f"error {entry}·ε off the {value} row ({dtype})")
        row[name] = {"nan": int(torch.isnan(bad).sum()),
                     "inf": int(torch.isinf(bad).sum()),
                     "entry_ratio_max": entry}
    return row


def herk_sass_counts(_build):
    """Tensor-core and FMA instructions in the SASS of each instance of
    K5's kernel (``cuobjdump -sass`` of the built library): each float64
    instance must hold DMMA and each float32 one TF32 HMMA, so no main
    loop is FFMA/DFMA-only."""
    import re
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build._lib_path("herk_lower")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"herk_lower_kernelI([fd])Li(\d+)E", line)
            cur = m and counts.setdefault(
                f"{'f32' if m[1] == 'f' else 'f64'}_tile{m[2]}",
                {"DMMA": 0, "HMMA_TF32": 0, "HMMA": 0, "DFMA": 0, "FFMA": 0})
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur is None or not op:
            continue
        base = op[1].split(".")[0]
        if base in cur:
            cur[base] += 1
        if base == "HMMA" and "TF32" in op[1]:
            cur["HMMA_TF32"] += 1
    check(sorted(counts) == ["f32_tile128", "f32_tile64", "f64_tile128",
                             "f64_tile64"],
          f"herk_lower_update SASS: kernel instances {sorted(counts)}")
    for inst, cnt in counts.items():
        mma = cnt["DMMA"] if inst.startswith("f64") else cnt["HMMA_TF32"]
        check(mma > 0, f"herk_lower_update {inst}: no tensor-core "
              f"instruction in its SASS: {cnt}")
    return counts


def leaf_stack(torch, nblk, s, dtype, unit, gen):
    """A (nblk, s, s) stack of well-conditioned lower-triangular leaves
    with 1e6 junk in the strict upper triangles, and the same stack with
    zero there."""
    def draw():
        return torch.randn((nblk, s, s), generator=gen, device="cuda",
                           dtype=dtype)
    off = torch.tril(draw(), -1) / (s if unit else math.sqrt(s))
    diag = 2 + draw().diagonal(dim1=1, dim2=2).abs()
    clean = off + torch.diag_embed(diag.to(dtype))
    return clean + 1e6 * torch.triu(draw(), 1), clean


def leaf_ratio(torch, x, xp, lo, unit):
    """The worst |x − xp|ᵢⱼ / (s·ε·(|xp|·|L|·|xp|)ᵢⱼ) over the entries
    where xp is finite, in float64; L the lower triangle of ``lo`` (1 on
    a unit diagonal)."""
    s = lo.shape[-1]
    lt = torch.tril(lo).abs().double()
    if unit:
        lt.diagonal(dim1=-2, dim2=-1).fill_(1)
    ax = xp.abs().double()
    fin = torch.isfinite(ax)
    ax = torch.where(fin, ax, 0)
    eps = torch.finfo(x.real.dtype if x.is_complex() else x.dtype).eps
    denom = s * eps * (ax @ lt @ ax)
    diff = (x - xp).abs().double()
    ratio = torch.where(fin & (diff > 0), diff / denom, 0)
    return ratio.max().item()


def trtri_case(torch, ho, blocked, nblk, s, dtype, unit, gen, timed=False,
               view=None, zero_diag=None):
    """P1 against its plain version: entrywise within
    LEAF_ENTRY_C·s·ε·(|X|·|L|·|X|)ᵢⱼ, the strict upper triangle of X
    exactly zero, non-finite entries in the same places, and junk in the
    strict upper triangle of L changing nothing (bitwise). ``view``:
    "diag" hands over the diagonal leaves of an (nblk·s)² matrix as one
    strided view, "batch" the [s:, s:] blocks of a (nblk, 2s, 2s) stack
    (the batched engine's leaves), "t" a transposed view of
    upper-triangular leaves (unit row stride), "conj_t" a
    conjugate-transposed one. ``zero_diag``: that
    diagonal entry of leaf 0 is 0. Timed rows also carry the device time
    per launch of the kernel and of the library call (``device_ms``)."""
    junk, clean = leaf_stack(torch, nblk, s, dtype, unit, gen)
    if zero_diag is not None:
        junk[0, zero_diag, zero_diag] = 0
        clean[0, zero_diag, zero_diag] = 0
    l = junk
    if view == "diag":
        big = torch.zeros((nblk * s, nblk * s), dtype=dtype, device="cuda")
        blocked._blocks(big, 0, s, s).copy_(junk)
        l = blocked._blocks(big, 0, s, s)
    elif view == "t":
        l = junk.mT.contiguous().mT  # upper leaves, read transposed
        check(l.stride(1) == 1 and not l.is_contiguous(), "P1 t: no view")
    elif view == "batch":  # the engine's leaves: blocks of a stack
        l = in_stack(torch, junk, 2 * s, s)
    elif view == "conj_t":
        l = junk.mH.contiguous().mH  # a conjugate, transposed view
        check(l.is_conj() and not l.is_contiguous(), "P1 conj_t: no view")
    xk = ho.trtri_leaves(l, unit)
    xp = ho.trtri_leaves_plain(l, unit)
    x_clean = ho.trtri_leaves(clean, unit)
    torch.cuda.synchronize()
    name = f"trtri_leaves {(nblk, s, s)} {dtype} unit={unit} view={view}"
    check(torch.equal(torch.isfinite(xk), torch.isfinite(xp)),
          f"{name}: non-finite entries differ from the plain version")
    check(torch.equal(xk, x_clean) if zero_diag is None else
          torch.equal(torch.isfinite(xk), torch.isfinite(x_clean)),
          f"{name}: junk in the strict upper triangle changed X")
    check(torch.count_nonzero(torch.triu(xk, 1)).item() == 0,
          f"{name}: nonzero above the diagonal")
    ratio = leaf_ratio(torch, xk, xp, clean, unit)
    check(math.isfinite(ratio) and ratio <= ho.LEAF_ENTRY_C,
          f"{name}: entrywise error {ratio}·s·ε > {ho.LEAF_ENTRY_C}")
    fin = torch.isfinite(xp)
    err = (xk - xp).abs()[fin].max().item()
    row = {"B": nblk, "s": s, "dtype": str(dtype).split(".")[1],
           "unit": unit, "view": view, "max_abs_err": err,
           "entry_ratio_max": ratio, "entry_limit": ho.LEAF_ENTRY_C}
    if zero_diag is not None:
        row["zero_diag"] = zero_diag
        row["nonfinite"] = int((~fin).sum())
        bad = torch.zeros((s, s), dtype=torch.bool, device="cuda")
        bad[zero_diag:, :zero_diag + 1] = True
        check(torch.equal(~torch.isfinite(xk[0]), bad)
              and bool(torch.isfinite(xk[1:]).all()),
              f"{name}: a zero diagonal at {zero_diag} did not make exactly "
              "rows ≥ it, columns ≤ it non-finite")
    if timed:
        eye = torch.eye(s, dtype=dtype, device="cuda").expand(nblk, s, s)
        row["ms"] = cuda_ms(lambda: ho.trtri_leaves(l, unit))
        row["plain_ms"] = cuda_ms(lambda: ho.trtri_leaves_plain(l, unit),
                                  reps=5)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.solve_triangular(
            l, eye, upper=False, unitriangular=unit))
        row["device_ms"] = device_ms(lambda: ho.trtri_leaves(l, unit))
        row["library_device_ms"] = device_ms(
            lambda: torch.linalg.solve_triangular(l, eye, upper=False,
                                                  unitriangular=unit))
        it = l.element_size()
        # the lower triangle read once, X written once; s³/3 operations
        # per leaf (about four times as many real ones for a complex type)
        real = {"complex64": "float32", "complex128": "float64"}
        row["bound_ms"], row["bound_by"] = bound(
            nblk * (s * (s + 1) // 2 + s * s) * it,
            nblk * s ** 3 / 3.0 * (4 if dtype.is_complex else 1),
            real.get(row["dtype"], row["dtype"]))
    return row


def trtri_sweep(torch, ho, blocked, gen):
    """P1 at every leaf size s = 1, ..., 64 in float32, float64 and
    complex128 (two leaves; unit on even s; contiguous, strided diagonal
    and transposed views in turn), each case checked as trtri_case checks
    it: the ragged last blocks of every combine level, where a sum could
    reach rows past s (s = 34 and 36 at the 32-wide level). One row."""
    worst, cases = 0.0, 0
    for dtype in (torch.float32, torch.float64, torch.complex128):
        for s in range(1, 65):
            row = trtri_case(torch, ho, blocked, 2, s, dtype, s % 2 == 0,
                             gen, view=(None, "diag", "t")[s % 3])
            worst = max(worst, row["entry_ratio_max"])
            cases += 1
    return {"sweep": "s = 1..64", "B": 2,
            "dtypes": ["float32", "float64", "complex128"], "cases": cases,
            "entry_ratio_max": worst, "entry_limit": ho.LEAF_ENTRY_C}


def exact_zero_pivot(torch, s, zero_at, dtype, gen):
    """L·U with entries in {−1, 0, 1}, unit-diagonal U except
    U[zero_at, zero_at] = 0 and L zero below it: every step of the
    no-pivot LU is exact and the pivot of step ``zero_at`` is 0."""
    def pick(*shape):
        return torch.randint(-1, 2, shape, generator=gen,
                             device="cuda").to(dtype)
    eye = torch.eye(s, dtype=dtype, device="cuda")
    lo = torch.tril(pick(s, s), -1) + eye
    up = torch.triu(pick(s, s), 1) + eye
    up[zero_at, zero_at] = 0
    lo[zero_at + 1:, zero_at] = 0
    return lo @ up


def same_bits(torch, x, y) -> bool:
    """NaN in the same places and every other entry equal bit for bit
    (the sign of a zero and ±Inf included)."""
    if x.is_complex():
        x, y = torch.view_as_real(x), torch.view_as_real(y)
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return False
    it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return torch.equal(x.view(it)[~nan], y.view(it)[~nan])


def nopiv_leaf(torch, s, dtype, gen, zero_at=None, nan_at=None,
               signed_zeros=False):
    """A leaf for P2: diagonally dominant Gaussian, with exact zeros of
    both signs in about a fifth of its off-diagonal entries each
    (``signed_zeros``), a NaN at ``nan_at``, or exact integer factors
    with a zero pivot at step ``zero_at``."""
    if zero_at is not None:
        return exact_zero_pivot(torch, s, zero_at, dtype, gen)
    a = torch.randn((s, s), generator=gen, device="cuda", dtype=dtype)
    diag = a.diagonal() + s
    if signed_zeros:
        z = torch.rand((s, s), generator=gen, device="cuda")
        a[z < 0.2] = -0.0
        a[(z >= 0.2) & (z < 0.4)] = 0.0
    a.diagonal().copy_(diag)
    if nan_at is not None:
        a[nan_at] = math.nan
    return a


# fresh copies of a leaf for the in-place form: one per timed launch
NOPIV_POOL = 160


def nopiv_view(t, s, view):
    """The s × s view of a larger matrix t that P2 factors in place: a
    row-major leaf at an offset ("strided") or a transposed one ("t")."""
    return t[3:3 + s, 5:5 + s] if view == "strided" else t.mT[5:5 + s, 3:3 + s]


def lu_nopiv_case(torch, ho, s, dtype, gen, timed=False, zero_at=None,
                  nan_at=None, view=None, signed_zeros=False):
    """P2 against its plain version: info exact and L\\U bit for bit
    (NaN in the same places). ``view``: the in-place form on a strided
    ("strided") or transposed ("t") view of a larger matrix, whose other
    entries must not change; else the out-of-place ``lu_nopiv_base``.
    Timed rows: one call of the in-place form (the main path's) by CUDA
    events, and its device time per launch, each launch on a fresh copy,
    beside the plain version and ``torch.linalg.lu_factor``."""
    a = nopiv_leaf(torch, s, dtype, gen, zero_at, nan_at, signed_zeros)
    lp, ip = ho.lu_nopiv_base_plain(a)
    name = f"lu_nopiv_base {(s, s)} {dtype} view={view}"
    if view is None:
        lk, ik = ho.lu_nopiv_base(a)
    else:
        big = torch.randn((s + 9, s + 13), generator=gen, device="cuda",
                          dtype=dtype)
        leaf = nopiv_view(big, s, view)
        leaf.copy_(a)
        want = big.clone()
        nopiv_view(want, s, view).copy_(lp)
        ik = torch.zeros((), dtype=torch.int32, device="cuda")
        ho.lu_nopiv_base_inplace(leaf, ik)
        lk = leaf
        torch.cuda.synchronize()
        check(same_bits(torch, big, want), f"{name}: the view is not the "
              "plain version's L\\U bit for bit, or an entry outside it "
              "changed")
    torch.cuda.synchronize()
    check(int(ik) == int(ip), f"{name}: info {int(ik)} != {int(ip)}")
    if zero_at is not None:
        check(int(ik) == zero_at + 1, f"{name}: info {int(ik)} for a zero "
              f"pivot at step {zero_at}")
    if nan_at is not None:
        check(int(ik) == nan_at[0] + 1, f"{name}: info {int(ik)} for a NaN "
              f"at {nan_at}")
    check(same_bits(torch, lk, lp),
          f"{name}: not bit for bit the plain version's L\\U")
    diff = (lk - lp)[torch.isfinite(lp)]
    row = {"s": s, "dtype": str(dtype).split(".")[1], "view": view,
           "info": int(ik),
           "max_abs_err": diff.abs().max().item() if diff.numel() else 0.0,
           "bitwise_equal": True}
    if zero_at is not None:
        row["zero_pivot_step"] = zero_at
    if nan_at is not None:
        row["nan_at"] = list(nan_at)
    if signed_zeros:
        row["signed_zeros"] = True
    if timed:
        pool = a.expand(NOPIV_POOL, s, s).clone()
        slot = torch.zeros((), dtype=torch.int32, device="cuda")
        taken = itertools.count()

        def launch():
            ho.lu_nopiv_base_inplace(pool[next(taken) % NOPIV_POOL], slot)

        row["ms"] = cuda_ms(launch)
        pool.copy_(a.expand(NOPIV_POOL, s, s))  # fresh copies again
        row["device_ms"] = device_ms(launch)
        row["plain_ms"] = cuda_ms(lambda: ho.lu_nopiv_base_plain(a), reps=5)
        row["library_ms"] = cuda_ms(
            lambda: torch.linalg.lu_factor(a, pivot=False))
        # lu_factor(pivot=False) waits for the host inside every call, so
        # no queue of its calls can be timed behind a sleep;
        # tools/p2_ablation.py reads its device time by the profiler
        row["library_device_ms"] = None
        check(int(slot) == 0, f"{name}: a timed launch set info")
        it = a.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            2 * s * s * it + 4, 2.0 * s ** 3 / 3.0, row["dtype"])
    return row


def lu_nopiv_sweep(torch, ho, gen):
    """P2 at every leaf size s = 1, ..., 64 in float32 and float64, each
    case checked as lu_nopiv_case checks it, in turn contiguous, in place
    on a strided view and on a transposed view, with signed zeros, a NaN
    or a zero pivot on every other s. One row."""
    cases = 0
    for dtype in (torch.float32, torch.float64):
        for s in range(1, 65):
            kind = s % 4
            lu_nopiv_case(torch, ho, s, dtype, gen,
                          view=(None, "strided", "t")[s % 3],
                          signed_zeros=kind == 1,
                          nan_at=(s // 2, s // 3) if kind == 2 else None,
                          zero_at=s // 2 if kind == 3 and s > 1 else None)
            cases += 1
    return {"sweep": "s = 1..64", "dtypes": ["float32", "float64"],
            "cases": cases, "bitwise_equal": True}


def lu_nopiv_info_offsets(torch, ho, gen):
    """Two 64-row leaves on the diagonal of one 128 × 128 matrix, factored
    in place in order into one info slot with step offsets 0 and 64, as
    the no-pivot factor does: a zero pivot at step 20 of the second leaf
    gives info 85; zero pivots at step 10 of the first and 20 of the
    second give 11 (the first wins). Each leaf bit for bit the plain
    version's."""
    out = {}
    for zeros in ((None, 20), (10, 20)):
        big = torch.randn((128, 128), generator=gen, device="cuda")
        want, infos = big.clone(), []
        for b, z in enumerate(zeros):
            leaf = nopiv_leaf(torch, 64, torch.float32, gen, zero_at=z)
            big[64 * b:64 * b + 64, 64 * b:64 * b + 64] = leaf
            lp, ip = ho.lu_nopiv_base_plain(leaf)
            want[64 * b:64 * b + 64, 64 * b:64 * b + 64] = lp
            infos.append(int(ip))
        slot = torch.zeros((), dtype=torch.int32, device="cuda")
        for b in range(2):
            ho.lu_nopiv_base_inplace(
                big[64 * b:64 * b + 64, 64 * b:64 * b + 64], slot, 64 * b)
        expect = infos[0] if infos[0] else infos[1] + 64
        check(int(slot) == expect == (11 if zeros[0] else 85),
              f"lu_nopiv_base offsets {zeros}: info {int(slot)}, "
              f"expected {expect}")
        check(same_bits(torch, big, want), f"lu_nopiv_base offsets {zeros}: "
              "not the plain version's leaves bit for bit")
        out[f"zero_pivots_{zeros}"] = int(slot)
    return out


def batched_stack(torch, bsz, hh, w, dtype, gen, fault=None):
    """A (B, H, w) Gaussian stack for P3, with a fault: "zero_column"
    (column 3 of chunk B // 2 zero), "nan" (a NaN in the last row of
    column 2 of chunk 0, zeros left of it, so that row must win that
    column's pivot; complex: inf + nan·i, whose modulus is NaN) or "tie"
    (column 0 of every chunk ±1, complex 1, −1, i, −i in turn, so row 0
    must win; in the last chunk column 1 of modulus at most 1 but 7.0 at
    rows 5 and 9, which stay tied, so row 5 must win there)."""
    a = torch.randn((bsz, hh, w), generator=gen, device="cuda", dtype=dtype)
    if fault == "zero_column":
        a[bsz // 2, :, 3] = 0
    elif fault == "nan":
        a[0, hh - 1, :2] = 0
        a[0, hh - 1, 2] = (complex(math.inf, math.nan) if a.is_complex()
                           else math.nan)
    elif fault == "tie" and a.is_complex():
        # column 0 all of modulus 1 in four phases, so row 0 must win
        phase = torch.tensor([1, -1, 1j, -1j], dtype=dtype, device="cuda")
        a[:, :, 0] = phase[torch.arange(hh, device="cuda") % 4]
        a[-1, :, 1] /= a[-1, :, 1].abs().max()
        a[-1, [5, 9], 1] = 7.0
    elif fault == "tie":
        a[:, :, 0] = torch.where(torch.arange(hh, device="cuda") % 2 == 1,
                                 -1.0, 1.0).to(dtype)
        a[-1, :, 1].clamp_(-1, 1)
        a[-1, [5, 9], 1] = 7.0
    return a


def p3_plan_row(ho, a):
    """The cluster plan P3 launches with for the stack ``a``; the plan's
    shared memory per CTA must be the launcher's."""
    bsz, hh, w = a.shape
    plan = ho.lu_panel_batched_plan_for(a)
    launch_smem = ho.lu_panel_batched_launch_smem(hh, w, a.element_size(),
                                                  plan)
    check(plan.smem_bytes == launch_smem,
          f"lu_panel_batched {(bsz, hh, w)}: the plan counts "
          f"{plan.smem_bytes} bytes of shared memory, the launcher "
          f"{launch_smem}")
    return {"clusters": bsz, "ctas": plan.ctas, "rows": plan.rows,
            "mode": plan.mode, "smem_bytes": plan.smem_bytes,
            "launches_per_call": 1}


def check_p3_modes(rows):
    """The kernel phase must run P3 with resident and with streaming
    CTAs, and on both sides of the boundary between them: (1, 1744, 512)
    f32 resident at 16 CTAs (109 rows a CTA), (1, 1745, 512) streaming."""
    modes = {r["plan"]["mode"] for r in rows}
    edge = {r["H"]: r["plan"] for r in rows
            if r["B"] == 1 and r["w"] == 512 and r["H"] in (1744, 1745)}
    check(modes == {"resident", "streaming"} and len(edge) == 2
          and edge[1744]["mode"] == "resident"
          and edge[1745]["mode"] == "streaming",
          f"lu_panel_batched: the cases did not cover both plan modes and "
          f"their boundary: {modes}, {edge}")


def lu_batched_case(torch, ho, bsz, hh, w, dtype, gen, timed=False,
                    fault=None):
    """P3 against its plain version on the same stack: lu bit for bit (NaN
    in the same places), perm and info exact, and the fault's contract
    (``batched_stack``): with a zero column, info 4 in that chunk and
    every other chunk bit for bit the kernel's result on the stack
    without it. Timed rows: one launch by CUDA events and by device time
    per launch, the plain version and batched torch.linalg.lu_factor
    (cuSOLVER) on the same stack."""
    a = batched_stack(torch, bsz, hh, w, dtype, gen, fault)
    lk, pk, ik = ho.lu_panel_batched(a)
    lp, pp, ip = ho.lu_panel_batched_plain(a)
    torch.cuda.synchronize()
    name = f"lu_panel_batched {(bsz, hh, w)} {dtype} fault={fault}"
    check(torch.equal(pk, pp), f"{name}: perm differs")
    check(torch.equal(ik, ip), f"{name}: info {ik.tolist()} != "
          f"{ip.tolist()}")
    check(same_bits(torch, lk, lp),
          f"{name}: lu not bit for bit the plain version's")
    if fault == "zero_column":
        want = [0] * bsz
        want[bsz // 2] = 4
        clean = a.clone()
        clean[bsz // 2] = torch.randn((hh, w), generator=gen, device="cuda",
                                      dtype=dtype)
        lc, pc, ic = ho.lu_panel_batched(clean)
        keep = [b for b in range(bsz) if b != bsz // 2]
        check(ik.tolist() == want and same_bits(torch, lk[keep], lc[keep])
              and torch.equal(pk[keep], pc[keep]) and not ic.any(),
              f"{name}: info {ik.tolist()}, or another chunk changed")
    elif fault == "nan":
        check(int(ik[0]) == 3 and int(pk[0, 2]) == hh - 1,
              f"{name}: info {ik.tolist()}, pivot {int(pk[0, 2])}")
    elif fault == "tie":
        check(bool((pk[:, 0] == 0).all()) and int(pk[-1, 1]) == 5,
              f"{name}: pivots {pk[:, 0].tolist()}, {int(pk[-1, 1])}")
    fin = torch.isfinite(lp)
    diff = (lk - lp)[fin]
    row = {"B": bsz, "H": hh, "w": w, "dtype": str(dtype).split(".")[1],
           "plan": p3_plan_row(ho, a),
           "info": ik.tolist() if bsz <= 8 else int(ik.count_nonzero()),
           "max_abs_err": diff.abs().max().item() if diff.numel() else 0.0,
           "bitwise_equal": True}
    if fault is not None:
        row["fault"] = fault
    if timed:
        row["ms"] = cuda_ms(lambda: ho.lu_panel_batched(a))
        row["device_ms"] = device_ms(lambda: ho.lu_panel_batched(a),
                                     launches=10)
        row["plain_ms"] = cuda_ms(lambda: ho.lu_panel_batched_plain(a),
                                  reps=3)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.lu_factor(a))
        s = a.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            bsz * (2 * hh * w * s + 4 * hh + 4),
            bsz * (hh * w * w - w ** 3 / 3.0), row["dtype"])
        # the other bound, for PERF.md's row: bytes and operations each
        row["bound_bytes_ms"] = bsz * (2 * hh * w * s + 4 * hh + 4) \
            / PEAK_BYTES_PER_S * 1e3
        row["bound_operations_ms"] = real_ops(
            bsz * (hh * w * w - w ** 3 / 3.0), row["dtype"]) \
            / PEAK_FLOPS[row["dtype"]] * 1e3
    return row


def spd_stack(torch, bsz, s, dtype, gen):
    """A (bsz, s, s) stack of SPD (complex: Hermitian positive definite)
    items, x·xᴴ/s + I, with 1e6 junk in the strict upper triangles and,
    complex, 3i on the diagonals (P4 must read neither)."""
    wide_t = torch.complex128 if dtype.is_complex else torch.float64
    x = torch.randn((bsz, s, s), generator=gen, device="cuda", dtype=wide_t)
    a = (x @ x.mH / s + torch.eye(s, device="cuda", dtype=wide_t))
    a = torch.tril(a) + 1e6 * torch.triu(torch.ones_like(a), 1)
    if dtype.is_complex:
        a.diagonal(dim1=1, dim2=2).add_(3j)
    return a.to(dtype)


def in_stack(torch, a, n_big, k0):
    """``a`` (B, s, w) written into a zero (B, n_big, n_big) stack at
    [k0:, k0:] and returned as that strided view (the block the engine
    hands its kernels)."""
    bsz, s, w = a.shape
    big = torch.zeros((bsz, n_big, n_big), dtype=a.dtype, device="cuda")
    view = big[:, k0:k0 + s, k0:k0 + w]
    view.copy_(a)
    check(not view.is_contiguous(), "in_stack: not a strided view")
    return view


def chol_batched_case(torch, ho, bsz, s, dtype, gen, timed=False,
                      n_big=None, faults=()):
    """P4 against its plain version on the same stack: L bit for bit (NaN
    in the same places), info exact, strict upper triangles zero. With
    ``n_big`` the items are the (k0 = n_big − s) diagonal blocks of a
    (bsz, n_big, n_big) stack, read as that strided view. ``faults``:
    item i + 1 gets d[p, p] = −1 for the i-th pivot p: info p + 1 there,
    and every other item bit for bit as on the stack without faults.
    Timed rows: one launch by CUDA events and by device time per launch,
    the plain version and batched torch.linalg.cholesky_ex."""
    clean = spd_stack(torch, bsz, s, dtype, gen)
    a = clean.clone()
    want = [0] * bsz
    for i, p in enumerate(faults):
        a[i + 1, p, p] = -1.0
        want[i + 1] = p + 1
    if n_big is not None:
        a = in_stack(torch, a, n_big, n_big - s)
        clean = in_stack(torch, clean, n_big, n_big - s)
    lk, ik = ho.chol_tile_batched(a)
    lp, ip = ho.chol_tile_batched_plain(a)
    lc, ic = ho.chol_tile_batched(clean)
    torch.cuda.synchronize()
    name = f"chol_tile_batched {(bsz, s, s)} {dtype} n_big={n_big}"
    check(same_bits(torch, lk, lp), f"{name}: L not bit for bit the plain "
          "version's")
    check(ik.tolist() == ip.tolist() == want and not ic.any(),
          f"{name}: info {ik.tolist()[:8]}, plain {ip.tolist()[:8]}, "
          f"expected {want[:8]}")
    keep = [b for b in range(bsz) if want[b] == 0]
    check(same_bits(torch, lk[keep], lc[keep]),
          f"{name}: a faulty item changed its neighbours")
    check(torch.count_nonzero(torch.triu(lk, 1)).item() == 0,
          f"{name}: nonzero above the diagonal")
    row = {"B": bsz, "s": s, "dtype": str(dtype).split(".")[1],
           "view": None if n_big is None else f"[{n_big - s}:, {n_big - s}:] "
           f"of ({bsz}, {n_big}, {n_big})",
           "faults": list(faults), "max_abs_err": 0.0,
           "bitwise_equal": True, "launches_per_call": 1}
    if timed:
        row["ms"] = cuda_ms(lambda: ho.chol_tile_batched(a))
        row["device_ms"] = device_ms(lambda: ho.chol_tile_batched(a),
                                     launches=20)
        row["plain_ms"] = cuda_ms(lambda: ho.chol_tile_batched_plain(a),
                                  reps=3)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(a))
        row["library_device_ms"], row["library_device_by"] = \
            library_device_ms(torch, lambda: torch.linalg.cholesky_ex(a), 20)
        it = a.element_size()
        nbytes = bsz * ((s * (s + 1) // 2 + s * s) * it + 4)
        flops = bsz * s ** 3 / 3.0
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                 row["dtype"])
        row["bound_bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        row["bound_operations_ms"] = real_ops(flops, row["dtype"]) \
            / PEAK_FLOPS[row["dtype"]] * 1e3
    return row


def chol_batched_sweep(torch, ho, gen):
    """P4 at every s = 1, ..., 64 in float32 and float64: four items, the
    last three with a non-positive pivot at 0, min(20, s − 1) and s − 1,
    on a contiguous stack and on strided diagonal blocks in turn. One
    row."""
    cases = 0
    for dtype in (torch.float32, torch.float64):
        for s in range(1, 65):
            chol_batched_case(torch, ho, 4, s, dtype, gen,
                              n_big=s + 8 if s % 2 else None,
                              faults=(0, min(20, s - 1), s - 1))
            cases += 1
    return {"sweep": "s = 1..64", "B": 4, "faults": "0, min(20, s-1), s-1",
            "dtypes": ["float32", "float64"], "cases": cases,
            "bitwise_equal": True}


def p5_plan_row(ho, a):
    """The plan P5 launches with for the stack ``a``; its shared memory
    per CTA must be the launcher's."""
    bsz, hh, w = a.shape
    plan = ho.qr_panel_batched_plan(hh, w, a.element_size())
    launch_smem = ho.qr_panel_batched_launch_smem(hh, w, a.element_size(),
                                                  plan)
    check(plan.smem_bytes == launch_smem,
          f"qr_panel_batched {(bsz, hh, w)}: the plan counts "
          f"{plan.smem_bytes} bytes of shared memory, the launcher "
          f"{launch_smem}")
    return {"team": plan.team, "threads": plan.threads,
            "items_per_cta": plan.items_per_cta,
            "rows_per_thread": plan.rows_per_thread,
            "storage": plan.storage, "smem_bytes": plan.smem_bytes,
            "ctas": -(-bsz // plan.items_per_cta), "launches_per_call": 1}


def p5_boundary_shapes(torch, ho, dtypes=None):
    """(H, w, dtype) on each side of every boundary of P5's plan, in
    float32 and float64 unless ``dtypes`` is given: warp ↔ CTA team and
    registers ↔ shared by height, registers ↔ shared by width, shared ↔
    streaming, each height found by searching the plan at w = 32 (a type
    without a registers plan, complex128, has only the last). Each pair
    is checked to straddle its boundary."""
    shapes = []
    for dt in dtypes or (torch.float32, torch.float64):
        it = torch.empty(0, dtype=dt).element_size()

        def plan(hh, w):
            return ho.qr_panel_batched_plan(hh, w, it)

        def last(keep):  # the largest height at w = 32 with keep(plan)
            lo, hi = 32, 2 ** 20
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if keep(plan(mid, 32)) else (lo, mid)
            return lo

        bounds = ((last(lambda p: p.team == "warp"), (32, 32), "team"),
                  (last(lambda p: p.storage == "registers"), (32, 32),
                   "storage"),
                  (100, (32, 33), "storage"))
        if plan(32, 32).storage != "registers":
            bounds = ()
        for h0, (w0, w1), key in bounds + (
                (last(lambda p: p.storage != "streaming"), (32, 32),
                 "storage"),):
            h1 = h0 if w1 != w0 else h0 + 1
            check(getattr(plan(h0, w0), key) != getattr(plan(h1, w1), key),
                  f"p5 boundary {(h0, w0)} | {(h1, w1)} {dt}: the same "
                  f"{key}")
            shapes += [(h0, w0, dt), (h1, w1, dt)]
    return shapes


def qr_batched_case(torch, ho, bsz, hh, w, dtype, gen, timed=False,
                    strided=False, fault=None):
    """P5 against its plain version on the same stack, per item within
    4·ε·max(√H, w): R relative to its item's max|R|, V and the taus
    absolute (qr_case's 4·ε·√H for the order of the H-long sums, where a
    panel of w ≥ √H columns compounds w steps of such differences). ``strided``: the panels are the right
    halves of a (bsz, hh, 2w) stack. ``fault``: "zero_column" (column 3
    of item bsz // 2: tau = 0 there in both) or "nan" (a NaN at
    (hh − 1, 3) of item 0: its taus NaN from column 3 on, its columns
    before finite, every other item bit for bit as without it). Timed
    rows: a float64 reconstruction of the first and last items, one
    launch by CUDA events and by device time per launch, the plain
    version and batched torch.geqrf."""
    clean = torch.randn((bsz, hh, w), generator=gen, device="cuda",
                        dtype=dtype)
    a = clean.clone()
    if fault == "zero_column":
        a[bsz // 2, :, 3] = 0
    elif fault == "nan":
        a[0, hh - 1, 3] = math.nan
    if strided:
        big = torch.zeros((bsz, hh, 2 * w), dtype=dtype, device="cuda")
        big[:, :, w:] = a
        a = big[:, :, w:]
    vk, tk = ho.qr_panel_batched(a)
    vp, tp = ho.qr_panel_batched_plain(a)
    torch.cuda.synchronize()
    name = f"qr_panel_batched {(bsz, hh, w)} {dtype} fault={fault}"
    items = [b for b in range(bsz) if not (fault == "nan" and b == 0)]
    upper = torch.ones((hh, w), dtype=torch.bool, device="cuda").triu()
    tol = 4 * torch.finfo(dtype).eps * max(math.sqrt(hh), w)
    vk_, vp_ = vk[items], vp[items]
    rmax = torch.where(upper, vp_, 0).abs().amax(dim=(1, 2))
    err_r = (torch.where(upper, vk_ - vp_, 0).abs().amax(dim=(1, 2))
             / rmax).max().item()
    err_v = torch.where(upper, 0, vk_ - vp_).abs().max().item()
    err_t = (tk[items] - tp[items]).abs().max().item()
    check(all(math.isfinite(e) and e <= tol for e in (err_r, err_v, err_t)),
          f"{name}: |kernel - plain| R {err_r} V {err_v} tau {err_t} "
          f"> {tol}")
    if fault == "zero_column":
        check(tk[bsz // 2, 3].item() == 0 == tp[bsz // 2, 3].item(),
              f"{name}: tau {tk[bsz // 2, 3].item()} on a zeroed column")
    elif fault == "nan":
        vc, tc = ho.qr_panel_batched(clean)
        top = min(w, hh - 1)
        check(bool(torch.isnan(tk[0, 3:top]).all())
              and bool(torch.isfinite(tk[0, :3]).all())
              and bool(torch.isfinite(vk[0, :, :3]).all())
              and same_bits(torch, vk[1:], vc[1:])
              and same_bits(torch, tk[1:], tc[1:]),
              f"{name}: the NaN did not stay in its item and column")
    row = {"B": bsz, "H": hh, "w": w, "dtype": str(dtype).split(".")[1],
           "strided": strided, "plan": p5_plan_row(ho, a),
           "max_abs_err": max(err_v, err_t, err_r * rmax.max().item()),
           "err_r_rel": err_r, "err_v": err_v, "err_tau": err_t, "tol": tol}
    if fault is not None:
        row["fault"] = fault
    if timed:
        rec = max(qr_reconstruction(torch, a[b], vk[b], tk[b])
                  for b in (0, bsz - 1))
        check(rec <= RESIDUAL_BOUND, f"{name}: ‖A − QR‖ / (H·ε·‖A‖) = "
              f"{rec} > {RESIDUAL_BOUND}")
        row["reconstruction"] = rec
        row["ms"] = cuda_ms(lambda: ho.qr_panel_batched(a))
        row["device_ms"] = device_ms(lambda: ho.qr_panel_batched(a),
                                     launches=10)
        row["plain_ms"] = cuda_ms(lambda: ho.qr_panel_batched_plain(a),
                                  reps=3)
        row["library_ms"] = cuda_ms(lambda: torch.geqrf(a), reps=3)
        row["library_device_ms"], row["library_device_by"] = \
            library_device_ms(torch, lambda: torch.geqrf(a), 3)
        it = a.element_size()
        nbytes = bsz * (2 * hh * w + w) * it
        flops = bsz * (2.0 * hh * w * w - 2.0 * w ** 3 / 3.0)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                 row["dtype"])
        row["bound_bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        row["bound_operations_ms"] = real_ops(flops, row["dtype"]) \
            / PEAK_FLOPS[row["dtype"]] * 1e3
    return row


# ---------------------------------------------------------------------------
# phases 4-5: factorizations and the serving path
# ---------------------------------------------------------------------------

def scaled_residuals(torch, A, X, B, in_wide=False):
    """Per column ‖b − A·x‖∞ / (n·ε·‖A‖∞·‖x‖∞), ε of A's type; with
    ``in_wide`` in float64 (complex128 for a complex A)."""
    n = A.shape[0]
    eps = torch.finfo(A.dtype).eps
    if in_wide:
        A, X, B = (wide(torch, t) for t in (A, X, B))
    anorm = A.abs().sum(dim=1).max()
    r = (B - A @ X).abs().max(dim=0).values
    return (r / (n * eps * anorm * X.abs().max(dim=0).values)).tolist()


def gels_residuals(torch, a64, eps, X, B):
    """Per column ‖Aᵀ(A·x − b)‖₁ / (m·ε·‖A‖₁²·‖x‖₁) in float64 (the
    reference tester's gels check); ``a64`` is A in float64, ``eps`` the
    working type's."""
    a, x, b = a64, X.double(), B.double()
    anorm = a.abs().sum(dim=0).max()
    rr = (a.T @ (a @ x - b)).abs().sum(dim=0)
    return (rr / (a.shape[0] * eps * anorm ** 2
                  * x.abs().sum(dim=0))).tolist()


def gels_check(torch, stt, ho, gen):
    """gels on the card against float64 numpy lstsq: (1500, 1000) at
    nb = 32 (K3 in every panel) and nb = 128 (K4), and the
    underdetermined (1000, 1500) at nb = 128 (gelqf)."""
    import numpy as np
    out = {}
    for name, (m, n), nb in (("gels_nb32", (1500, 1000), 32),
                             ("gels_nb128", (1500, 1000), 128),
                             ("gels_wide", (1000, 1500), 128)):
        a = torch.randn((m, n), generator=gen, device="cuda")
        b = torch.randn((m, 2), generator=gen, device="cuda")
        before = dict(ho.LAUNCHES)
        X = stt.gels(stt.from_dense(a, nb, device="cuda"),
                     stt.from_dense(b, nb, device="cuda"))
        torch.cuda.synchronize()
        launches = {k: ho.LAUNCHES[k] - before[k]
                    for k in ("qr_panel_base", "qr_panel_base_wide")}
        xs = X.to_numpy()
        check(xs.shape == (n, 2) and np.isfinite(xs).all(),
              f"{name}: bad output")
        ref = np.linalg.lstsq(a.double().cpu().numpy(),
                              b.double().cpu().numpy(), rcond=None)[0]
        rel = float(np.abs(xs - ref).max() / np.abs(ref).max())
        check(rel <= 1e-3, f"{name}: relative error {rel} vs float64 lstsq")
        row = {"m": m, "n": n, "nb": nb, "rel_err": rel,
               "launches": launches}
        if m >= n:
            res = max(gels_residuals(torch, a.double(),
                                     torch.finfo(a.dtype).eps,
                                     torch.from_numpy(xs).cuda(), b))
            check(res <= RESIDUAL_BOUND, f"{name}: residual {res}")
            row["scaled_residual"] = res
        out[name] = row
    k3 = out["gels_nb32"]["launches"]["qr_panel_base"]
    check(k3 >= 32, f"gels nb=32 launched qr_panel_base {k3} < 32 times")
    check(out["gels_nb128"]["launches"]["qr_panel_base_wide"] > 0,
          "gels nb=128 did not launch qr_panel_base_wide")
    return out


# (herk_lower_update, chol_tile) launches of the recursive potrf at
# nb = n/128, by n: one K5 per split (16384 → 8192 → 4096 → 2048, and
# 2048 → 1024 in the --n 2048 rehearsal), 128 K1 at the leaves
REC_POTRF_LAUNCHES = {16384: (7, 128), 2048: (1, 128)}
# trtri_leaves (P1) launches of the main path at nb = 512, by n, derived
# from the dispatch: every trtri_lower_batched of a power-of-two leaf
# grid is one launch, every trsm_rec base one, every smaller recursion
# leaf one.
#  chol factor: one per panel step but the last (nt − 1: 31, 3);
#  lu factor: per 512-wide panel 4 K2 bases and 8 leaves of panel_getrf's
#   64-row trsm_rec bases (2 + 4 + 2), plus inv11 per step but the last
#   (32·8 + 31 = 287; 4·8 + 3 = 35);
#  qr factor: per panel larft at 128, 256, 128 and 512 columns (16·4 =
#   64; 2·4 = 8);
#  chol_nb128 factor: 15 per 2048-row iterative leaf × 8, and one per
#   128-row trsm_rec base of the 7 splits (3 × 64) (120 + 192 = 312); at
#   n = 2048, nb = 16: 63 per 1024-row leaf × 2 and 64 for the one
#   split's 16-row bases (126 + 64 = 190);
#  a solve (any width): one per 512-row trsm_rec base of its two solves
#   (chol, lu: 2·32 = 64; qr: 16; chol_nb128 at 128 rows: 256);
#  potri: one over the 256 (32) leaves of trtri_rec; getri: as a solve;
#  the no-pivot factor: one per 64-row trsm_rec base (2048; 160) and one
#   P2 per 64-row leaf (256; 32).
#  the CALU factor (lu_calu): per panel top (512²) 24 in its no-pivot
#   recursion (8 + 2·4 + 4·2 at the 512-, 256- and 128-row nodes), 8 for
#   the rows below it and 8 for U12 (64-row trsm_rec bases), neither in
#   the last panel (31·40 + 24 = 1264; 3·40 + 24 = 144); 8 P2 leaves per
#   panel top (256; 32); P3 once per tournament round (P3_CALU_FACTOR).
P1_FACTOR = {16384: {"chol": 31, "lu": 287, "qr": 64, "chol_nb128": 312,
                     "nopiv": 2048, "lu_calu": 1264},
             2048: {"chol": 3, "lu": 35, "qr": 8, "chol_nb128": 190,
                    "nopiv": 160, "lu_calu": 144}}
P1_SOLVE = {16384: {"chol": 64, "lu": 64, "qr": 16, "chol_nb128": 256,
                    "nopiv": 64, "lu_calu": 64},
            2048: {"chol": 8, "lu": 8, "qr": 2, "chol_nb128": 256,
                   "nopiv": 8, "lu_calu": 8}}
P1_INVERSE = {16384: {"potri": 1, "getri": 64}, 2048: {"potri": 1, "getri": 8}}
P2_FACTOR = {16384: {"nopiv": 256, "lu_calu": 256},
             2048: {"nopiv": 32, "lu_calu": 32}}
# P3 launches of the CALU factor at nb = 512: one per tournament round,
# log2(chunks bucketed to a power of two) + 1 per panel: n = 16384,
# 16 panels of 6 rounds, 8 of 5, 4 of 4, 2 of 3, one of 2 and one of 1
# (161); n = 2048, 3 + 3 + 2 + 1 (9)
P3_CALU_FACTOR = {16384: 161, 2048: 9}


def cholqr_gels_check(torch, stt, ho, gen):
    """gels by CholQR at (20000, 9000), nb = 128, float32, against a
    float64 lstsq on the card: the Gram matrix has 71 block columns, so
    its potrf is the recursion and launches herk_lower_update 7 times."""
    m, n, nb = 20000, 9000, 128
    a = torch.randn((m, n), generator=gen, device="cuda")
    b = torch.randn((m, 2), generator=gen, device="cuda")
    before = dict(ho.LAUNCHES)
    t0 = time.perf_counter()
    X = stt.gels(stt.from_dense(a, nb, device="cuda"),
                 stt.from_dense(b, nb, device="cuda"),
                 stt.Options(method_gels=stt.MethodGels.CholQR))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: ho.LAUNCHES[k] - before[k] for k in ho.LAUNCHES}
    x = X.dense()[:n, :2]
    ref = torch.linalg.lstsq(a.double(), b.double(), driver="gels").solution
    rel = ((x.double() - ref).abs().max() / ref.abs().max()).item()
    check(X.shape == (n, 2) and bool(torch.isfinite(x).all()),
          "gels CholQR: bad output")
    check(rel <= 1e-3, f"gels CholQR: relative error {rel} vs float64 lstsq")
    check(launches["herk_lower_update"] == 7 and launches["chol_tile"] == 71,
          f"gels CholQR launched {launches}, expected (K5, K1) = (7, 71)")
    return {"m": m, "n": n, "nb": nb, "rel_err": rel, "seconds": seconds,
            "launches": launches}


def tsqr_check(torch, stt, gen):
    """tsqr at (4000, 300), nb = 64, float32: ‖Q·R − A‖ / ‖A‖ and
    ‖QᵀQ − I‖ (max entries) in float64, each ≤ 1e-4 (CholeskyQR2 leaves
    Q orthogonal to a small multiple of ε)."""
    m, n = 4000, 300
    a = torch.randn((m, n), generator=gen, device="cuda")
    Q, R = stt.tsqr(stt.from_dense(a, 64, device="cuda"))
    q, r = Q.dense()[:m, :n].double(), R.dense()[:n, :n].double()
    rec = ((q @ r - a.double()).abs().max() / a.abs().max()).item()
    orth = (q.T @ q - torch.eye(n, device="cuda",
                                dtype=torch.float64)).abs().max().item()
    check(rec <= 1e-4 and orth <= 1e-4,
          f"tsqr: reconstruction {rec}, orthogonality {orth}")
    return {"m": m, "n": n, "reconstruction": rec, "orthogonality": orth}


def blas3_check(torch, stt, gen):
    """The BLAS-3 verbs and norm on the card at small uneven sizes, float32,
    against float64 torch on the same inputs: relative error (to the
    largest entry of the float64 result) ≤ 1e-4. Symmetric/Hermitian/
    Triangular operands carry 1e6 junk in the triangle they do not store."""
    m, n, k, nb = 300, 200, 150, 64
    dev = "cuda"
    f64 = torch.float64

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def fd(x, **kw):
        return stt.from_dense(x, nb, device=dev, **kw)

    def logical(T):
        return T.dense()[: T.shape[0], : T.shape[1]].double()

    a, b, c = rnd(m, k), rnd(k, n), rnd(m, n)
    s_m, s_n = rnd(m, m), rnd(n, n)
    sym, herm = s_m + s_m.T, s_n + s_n.T
    junk_m, junk_n = 1e6 * torch.triu(rnd(m, m), 1), 1e6 * torch.tril(
        rnd(n, n), -1)
    tri = torch.tril(rnd(m, m)) + 4 * math.sqrt(m) * torch.eye(m, device=dev)
    csym = rnd(n, n)
    csym = csym + csym.T
    an, bn = rnd(n, k), rnd(n, k)
    A, B, C = a.double(), b.double(), c.double()
    rows = {}

    def rel(name, got, want):
        rows[name] = ((got - want).abs().max() / want.abs().max()).item()

    rel("gemm", logical(stt.multiply(1.5, fd(a), fd(b), -0.5, fd(c))),
        1.5 * A @ B - 0.5 * C)
    rel("symm", logical(stt.multiply(
        1.0, fd(torch.tril(sym) + junk_m, kind=stt.MatrixKind.Symmetric,
                uplo=stt.Uplo.Lower), fd(c), 0.5, fd(c))),
        sym.double() @ C + 0.5 * C)
    rel("hemm", logical(stt.multiply(
        1.0, fd(c), fd(torch.triu(herm) + junk_n,
                       kind=stt.MatrixKind.Hermitian, uplo=stt.Uplo.Upper),
        0.0, fd(c))), C @ herm.double())
    low = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    Cs = fd(csym, kind=stt.MatrixKind.Symmetric, uplo=stt.Uplo.Lower)
    AN, BN, CS = an.double(), bn.double(), csym.double()
    rel("syrk", logical(stt.rank_k_update(-1.0, fd(an), 1.0, Cs))[low],
        (CS - AN @ AN.T)[low])
    rel("syr2k", logical(stt.rank_2k_update(0.5, fd(an), fd(bn), 1.0,
                                            Cs))[low],
        (CS + 0.5 * (AN @ BN.T + BN @ AN.T))[low])
    T = fd(tri + junk_m, kind=stt.MatrixKind.Triangular, uplo=stt.Uplo.Lower)
    TR = tri.double()
    rel("trmm", logical(stt.triangular_multiply(2.0, T, fd(c))), 2.0 * TR @ C)
    rel("trsm", logical(stt.triangular_solve(2.0, T, fd(c))),
        torch.linalg.solve_triangular(TR, 2.0 * C, upper=False))
    Aa = fd(a)
    for kind, want in ((stt.Norm.One, A.abs().sum(0).max()),
                       (stt.Norm.Inf, A.abs().sum(1).max()),
                       (stt.Norm.Max, A.abs().max()),
                       (stt.Norm.Fro, torch.linalg.norm(A))):
        rows[f"norm_{kind.name}"] = abs(stt.norm(Aa, kind).double().item()
                                        - want.item()) / want.item()
    worst = max(rows.values())
    check(math.isfinite(worst) and worst <= 1e-4,
          f"BLAS-3 verbs against float64: {rows}")
    return rows


def small_check(torch, stt, gen):
    import numpy as np
    n, nb = 1000, 128
    x = torch.randn((n, n), generator=gen, device="cuda", dtype=torch.float32)
    spd = x @ x.T / n + torch.eye(n, device="cuda")
    gen_m = torch.randn((n, n), generator=gen, device="cuda") \
        + n ** 0.5 * torch.eye(n, device="cuda")
    b = torch.randn((n, 3), generator=gen, device="cuda")
    out = {}
    for name, A, solve in (
            ("posv", stt.hermitian(spd, nb, stt.Uplo.Lower, device="cuda"),
             stt.posv),
            ("gesv", stt.from_dense(gen_m, nb, device="cuda"), stt.gesv)):
        X, info = solve(A, stt.from_dense(b, nb, device="cuda"))
        xs = X.to_numpy()
        check(int(info) == 0 and xs.shape == (n, 3) and
              np.isfinite(xs).all(), f"{name}: bad output")
        dense = A.to_numpy().astype(np.float64)
        ref = np.linalg.solve(dense, b.double().cpu().numpy())
        rel = float(np.abs(xs - ref).max() / np.abs(ref).max())
        check(rel <= 1e-3, f"{name}: relative error {rel} vs float64 numpy")
        out[name] = rel
    return out


def inverse_residual(torch, a, x):
    """‖I − A·X‖₁ / (n·ε·‖A‖₁·‖X‖₁) in float64 (complex128 for a complex
    A) on the card, ε of A's type."""
    n = a.shape[0]
    a64, x64 = wide(torch, a), wide(torch, x)
    r = a64 @ x64
    r.diagonal().sub_(1)
    one = lambda m: m.abs().sum(dim=0).max().item()  # noqa: E731
    res = one(r) / (n * torch.finfo(a.dtype).eps * one(a64) * one(x64))
    del a64, x64, r
    return res


def dominant(torch, n, gen, dtype=None):
    """G/√n + 2·I, G Gaussian: no-pivot LU is stable on it."""
    a = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=dtype or torch.float32) / math.sqrt(n)
    a.diagonal().add_(2.0)
    return a


def inverse_verbs_check(torch, stt, gen):
    """The slice's verbs on the card at small uneven sizes (nb = 64),
    float32, against float64 numpy on the same inputs: trtri for both
    triangles and both diagonals, trtrm, potri, getri, getrf_nopiv and
    gesv_nopiv on a diagonally dominant matrix, and gesv_rbt on a
    diagonally dominant n = 256 and a Gaussian n = 300 (whose padded
    transform usually makes it fall back to partial pivoting; its steps
    and fallback are printed). Relative error to the largest entry
    ≤ 1e-3, for the inverses ‖I − A·X‖ scaled ≤ 30, for gesv_rbt the
    scaled residual ≤ 30 (the Gaussian's condition number makes its
    relative error a reading, not a check)."""
    import numpy as np
    from slate_tpu_torch.linalg import lu as lu_mod
    n, nb, dev = 300, 64, "cuda"
    out = {}

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    for lower in (True, False):
        for unit in (False, True):
            d = dominant(torch, n, gen)
            tri = torch.tril(d) if lower else torch.triu(d)
            if unit:
                tri = tri / n
                tri.diagonal().fill_(1)
            T = stt.triangular(tri + 1e6 * (torch.triu(d, 1) if lower
                                            else torch.tril(d, -1)),
                               nb, stt.Uplo.Lower if lower else stt.Uplo.Upper,
                               stt.Diag.Unit if unit else stt.Diag.NonUnit,
                               device=dev)
            x = stt.trtri(T).to_numpy()
            want = np.linalg.inv(tri.double().cpu().numpy())
            key = f"trtri_{'lower' if lower else 'upper'}_" \
                  f"{'unit' if unit else 'nonunit'}"
            out[key] = rel(x, want)
            res = inverse_residual(torch, tri,
                                   torch.from_numpy(x).to(tri.device))
            check(out[key] <= 1e-3 and res <= RESIDUAL_BOUND,
                  f"{key}: relative error {out[key]}, residual {res}")
    d = torch.tril(dominant(torch, n, gen))
    out["trtrm"] = rel(stt.trtrm(stt.triangular(d, nb, stt.Uplo.Lower,
                                                device=dev)).to_numpy(),
                       (d.T.double() @ d.double()).cpu().numpy())
    x = torch.randn((n, n), generator=gen, device=dev)
    spd = x @ x.T / n + torch.eye(n, device=dev)
    L, info = stt.potrf(stt.hermitian(spd, nb, stt.Uplo.Lower, device=dev))
    pinv = stt.chol_inverse_using_factor(L).dense()[:n, :n]
    out["potri"] = rel(pinv.cpu().numpy(),
                       np.linalg.inv(spd.double().cpu().numpy()))
    out["potri_residual"] = inverse_residual(torch, spd, pinv)
    g = torch.randn((n, n), generator=gen, device=dev) + math.sqrt(n) * \
        torch.eye(n, device=dev)
    LU, perm, _ = stt.lu_factor(stt.from_dense(g, nb, device=dev))
    ginv = stt.lu_inverse_using_factor(LU, perm).dense()[:n, :n]
    out["getri"] = rel(ginv.cpu().numpy(),
                       np.linalg.inv(g.double().cpu().numpy()))
    out["getri_residual"] = inverse_residual(torch, g, ginv)
    dd = dominant(torch, n, gen)
    b = torch.randn((n, 3), generator=gen, device=dev)
    X, info = stt.gesv_nopiv(stt.from_dense(dd, nb, device=dev),
                             stt.from_dense(b, nb, device=dev))
    check(int(info) == 0, f"gesv_nopiv: info {int(info)}")
    out["gesv_nopiv"] = rel(X.to_numpy(), np.linalg.solve(
        dd.double().cpu().numpy(), b.double().cpu().numpy()))
    rbt = stt.Options(method_lu=stt.MethodLU.RBT)
    for m, g in ((256, dominant(torch, 256, gen)),
                 (300, torch.randn((300, 300), generator=gen, device=dev))):
        bm = torch.randn((m, 2), generator=gen, device=dev)
        X = stt.lu_solve(stt.from_dense(g, nb, device=dev),
                         stt.from_dense(bm, nb, device=dev), rbt)
        x = X.to_numpy()
        res = max(scaled_residuals(torch, g, torch.from_numpy(x).to(
            g.device), bm))
        out[f"gesv_rbt_{m}"] = {
            "rel_err": rel(x, np.linalg.solve(g.double().cpu().numpy(),
                                              bm.double().cpu().numpy())),
            "scaled_residual": res, **lu_mod.RBT_LAST}
        check(res <= RESIDUAL_BOUND, f"gesv_rbt n={m}: scaled residual "
              f"{res} ({lu_mod.RBT_LAST})")
    worst = max(v for k, v in out.items() if isinstance(v, float)
                and not k.endswith("residual"))
    check(worst <= 1e-3 and out["potri_residual"] <= RESIDUAL_BOUND
          and out["getri_residual"] <= RESIDUAL_BOUND,
          f"the inverse and no-pivot verbs against float64 numpy: {out}")
    return out


def calu_check(torch, stt, ho, gen):
    """Tournament pivoting on the card at n = 300, nb = 64 (uneven),
    float32: getrf with MethodLU.CALU (‖A[perm] − L·U‖ / (n·ε·‖A‖)),
    gesv with CALU and with pivot_threshold = 0.5, each solution within
    1e-3 of float64 numpy's and its scaled residual ≤ 30; and a singular
    operator (column 77 zero), whose CALU info must be 78 and equal to the
    CPU run's. The CALU factor launches P3 once per tournament round
    (4 + 3 + 3 + 2 + 1 = 13 over its 5 panels of 320, 256, 192, 128 and
    64 rows) and no K2."""
    import numpy as np
    n, nb, dev = 300, 64, "cuda"
    a = torch.randn((n, n), generator=gen, device=dev)
    b = torch.randn((n, 3), generator=gen, device=dev)
    want = np.linalg.solve(a.double().cpu().numpy(), b.double().cpu().numpy())
    calu = stt.Options(method_lu=stt.MethodLU.CALU)
    out = {}
    before = dict(ho.LAUNCHES)
    LU, perm, info = stt.getrf(stt.from_dense(a, nb, device=dev), calu)
    got = {k: ho.LAUNCHES[k] - before[k] for k in ho.LAUNCHES}
    check(int(info) == 0 and got["lu_panel_batched"] == 13
          and got["lu_panel_base"] == 0,
          f"getrf CALU n={n}: info {int(info)}, launches {got}")
    lu = LU.to_numpy().astype(np.float64)
    p = perm.cpu().numpy()[:n]
    low = np.tril(lu, -1) + np.eye(n)
    a64 = a.double().cpu().numpy()
    out["calu_pa_lu"] = float(np.abs(a64[p] - low @ np.triu(lu)).max() / (
        n * torch.finfo(a.dtype).eps * np.abs(a64).max()))
    check(out["calu_pa_lu"] <= RESIDUAL_BOUND,
          f"getrf CALU: |A[perm] − L·U| scaled {out['calu_pa_lu']}")
    for name, opts in (("gesv_calu", calu),
                       ("gesv_threshold_0.5", stt.Options(pivot_threshold=0.5))):
        X, info = stt.gesv(stt.from_dense(a, nb, device=dev),
                           stt.from_dense(b, nb, device=dev), opts)
        x = X.to_numpy()
        rel = float(np.abs(x - want).max() / np.abs(want).max())
        res = max(scaled_residuals(torch, a, torch.from_numpy(x).to(dev), b))
        check(int(info) == 0 and rel <= 1e-3 and res <= RESIDUAL_BOUND,
              f"{name}: info {int(info)}, relative error {rel}, scaled "
              f"residual {res}")
        out[name] = {"rel_err": rel, "scaled_residual": res}
    sing = a.clone()
    sing[:, 77] = 0
    _, _, info = stt.getrf(stt.from_dense(sing, nb, device=dev), calu)
    _, _, info_cpu = stt.getrf(stt.from_dense(sing.cpu(), nb, device="cpu"),
                               calu)
    check(int(info) == int(info_cpu) == 78,
          f"getrf CALU of a singular operator: info {int(info)} on the "
          f"card, {int(info_cpu)} on the CPU, expected 78")
    out["singular_info"] = int(info)
    out["launches_getrf"] = got
    return out


def lstsq_normal64(torch, a64, B):
    """Least-squares solutions of the float64 (or complex128) ``a64`` for
    the columns of ``B`` by the normal equations in that type (accurate
    to about κ(A)²·ε₆₄; κ ≈ 3 for a 2:1 Gaussian)."""
    gram = a64.mH @ a64
    chol = torch.linalg.cholesky(gram)
    return torch.cholesky_solve(a64.mH @ wide(torch, B), chol)


def rel_errors(torch, X, ref):
    """Per column ‖x − x_ref‖∞ / ‖x_ref‖∞, x_ref in float64 (complex128
    for a complex X)."""
    d = (wide(torch, X) - ref).abs().max(dim=0).values
    return (d / ref.abs().max(dim=0).values).tolist()


def inverse_phase(torch, stt, ho, sess, ops, gen_m, b_rbt):
    """potri and getri on the resident chol and lu factors
    (``chol_inverse_using_factor``, ``lu_inverse_using_factor``), and one
    ``lu_solve`` of the general operator with MethodLU.RBT, each timed
    (host clock ending in a sync) with its launches; the inverses and the
    RBT solution are returned under x_* for the float64 checks."""
    from slate_tpu_torch.linalg import lu as lu_mod
    n, k = b_rbt.shape
    nb = sess._ops[ops["lu"]].A.nb
    out = {}
    runs = (("potri", lambda: stt.chol_inverse_using_factor(
                *sess.factor(ops["chol"]).payload)),
            ("getri", lambda: stt.lu_inverse_using_factor(
                *sess.factor(ops["lu"]).payload)),
            ("rbt", lambda: stt.lu_solve(
                stt.from_dense(gen_m, nb, device="cuda"),
                stt.from_dense(b_rbt, nb, device="cuda"),
                stt.Options(method_lu=stt.MethodLU.RBT))))
    for name, fn in runs:
        before = dict(ho.LAUNCHES)
        t0 = time.perf_counter()
        X = fn()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": {key: ho.LAUNCHES[key] - before[key]
                                  for key in ho.LAUNCHES}}
        out[f"x_{name}"] = X.dense()[:n, :n if name != "rbt" else k]
    out["rbt"].update(lu_mod.RBT_LAST)
    return out


def check_p1_p2(n, nb, factor_launches, solve_launches, inverse, requests):
    """P1, P2 and P3 launched as the dispatch says: fixed numbers where
    the tables above have n (at nb = 512), else at least once; P2 only in
    the no-pivot and CALU factors, P3 only in the CALU factor, and no
    K1–K5 launch from the inverses, the no-pivot or the CALU factor (K2
    in the RBT solve only if it fell back)."""
    exact = nb == 512 and n in P1_FACTOR
    kernels = ("chol_tile", "lu_panel_base", "qr_panel_base",
               "qr_panel_base_wide", "herk_lower_update")

    def want(got, table, key, what, scale=1):
        ok = got == scale * table[n][key] if exact else got > 0
        check(ok, f"{what} launched trtri_leaves {got} times, expected "
              f"{scale * table[n][key] if exact else '> 0'}")

    for name, fl in factor_launches.items():
        want(fl["trtri_leaves"], P1_FACTOR, name, f"the {name} factor")
        want(solve_launches[name]["trtri_leaves"], P1_SOLVE, name,
             f"the {name} solves", requests)
        p2, p3 = fl["lu_nopiv_base"], fl["lu_panel_batched"]
        check((p2 == P2_FACTOR[n][name] if exact else p2 > 0)
              if name in ("nopiv", "lu_calu") else p2 == 0,
              f"the {name} factor launched lu_nopiv_base {p2} times")
        check((p3 == P3_CALU_FACTOR[n] if exact else p3 > 0)
              if name == "lu_calu" else p3 == 0,
              f"the {name} factor launched lu_panel_batched {p3} times")
        check(solve_launches[name]["lu_nopiv_base"] == 0
              and solve_launches[name]["lu_panel_batched"] == 0,
              f"the {name} solves launched {solve_launches[name]}")
    for name in ("nopiv", "lu_calu"):
        check(not any(factor_launches[name][k] for k in kernels),
              f"the {name} factor launched {factor_launches[name]}")
    for name in ("potri", "getri"):
        got = inverse[name]["launches"]
        want(got["trtri_leaves"], P1_INVERSE, name, name)
        check(got["lu_nopiv_base"] == got["lu_panel_batched"] == 0
              and not any(got[k] for k in kernels),
              f"{name} launched {got}")
    rbt = inverse["rbt"]
    got = rbt["launches"]
    steps = 1 + rbt["refinements"]  # rbt_solve calls: one, then corrections
    if exact:
        p1 = P1_FACTOR[n]["nopiv"] + steps * P1_SOLVE[n]["lu"]
        if rbt["fallback"]:
            p1 += P1_FACTOR[n]["lu"] + P1_SOLVE[n]["lu"]
        check(got["trtri_leaves"] == p1
              and got["lu_nopiv_base"] == P2_FACTOR[n]["nopiv"]
              and got["lu_panel_base"] == (4 * n // nb if rbt["fallback"]
                                           else 0)
              and got["lu_panel_batched"] == 0,
              f"the RBT solve launched {got} after {rbt}, expected "
              f"{p1} trtri_leaves and {P2_FACTOR[n]['nopiv']} lu_nopiv_base")
    else:
        check(got["trtri_leaves"] > 0 and got["lu_nopiv_base"] > 0,
              f"the RBT solve launched {got}")


def main_path(torch, stt, ho, n, nb, gen):
    dev = "cuda"
    x = torch.randn((n, n), generator=gen, device=dev)
    spd = x @ x.T / n
    spd.diagonal().add_(1.0)
    del x
    gen_m = torch.randn((n, n), generator=gen, device=dev)
    # the no-pivot operator: diagonally dominant
    dom = dominant(torch, n, gen)
    # the least-squares operator: 2n × n/2, the same bytes as the others
    m_q, n_q = 2 * n, n // 2
    tall = torch.randn((m_q, n_q), generator=gen, device=dev)
    widths = (1, 16, 1, 16, 1, 16, 1, 16)
    rhs = {"chol": [torch.randn((n, k), generator=gen, device=dev)
                    for k in widths],
           "qr": [torch.randn((m_q, k), generator=gen, device=dev)
                  for k in widths]}
    rhs["lu"] = rhs["chol_nb128"] = rhs["nopiv"] = rhs["lu_calu"] = \
        rhs["chol"]
    b_rbt = torch.randn((n, 16), generator=gen, device=dev)
    # the SPD operator again at 128 block columns: potrf's 2×2 recursion
    nb_rec = n // 128
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ho.reset_launches()
    sess = stt.Session(hbm_budget=8 << 30, device=dev)
    ops = {"chol": sess.register(stt.hermitian(spd, nb, stt.Uplo.Lower,
                                               device=dev), op="chol"),
           "lu": sess.register(stt.from_dense(gen_m, nb, device=dev),
                               op="lu"),
           "qr": sess.register(stt.from_dense(tall, nb, device=dev),
                               op="auto"),
           "chol_nb128": sess.register(stt.hermitian(
               spd, nb_rec, stt.Uplo.Lower, device=dev), op="chol"),
           "nopiv": sess.register(stt.from_dense(dom, nb, device=dev),
                                  op="lu", opts=stt.Options(
                                      method_lu=stt.MethodLU.NoPiv)),
           # the general operator again, factored by tournament pivoting
           "lu_calu": sess.register(stt.from_dense(gen_m, nb, device=dev),
                                    op="lu", opts=stt.Options(
                                        method_lu=stt.MethodLU.CALU))}
    check(sess._ops[ops["chol_nb128"]].A.data.data_ptr() == spd.data_ptr(),
          "the nb = n/128 operator was registered with a copy")
    check(sess._ops[ops["qr"]].op == "qr",
          f"op auto inferred {sess._ops[ops['qr']].op!r} for a tall operand")
    factor_s, info, factor_launches = {}, {}, {}
    for name, h in ops.items():
        before = dict(ho.LAUNCHES)
        t0 = time.perf_counter()
        info[name] = sess.factor_info(h)
        torch.cuda.synchronize()
        factor_s[name] = time.perf_counter() - t0
        factor_launches[name] = {k: ho.LAUNCHES[k] - before[k]
                                 for k in ho.LAUNCHES}
    from slate_tpu_torch.runtime.metrics import Histogram
    latency = {name: Histogram() for name in ops}
    served = {name: [] for name in ops}
    solve_launches = {}
    for name, h in ops.items():
        before = dict(ho.LAUNCHES)
        for b in rhs[name]:
            t0 = time.perf_counter()
            xs = torch.from_numpy(sess.solve(h, b)).to(dev)
            latency[name].observe(time.perf_counter() - t0)
            served[name].append(xs)
        solve_launches[name] = {k: ho.LAUNCHES[k] - before[k]
                                for k in ho.LAUNCHES}
    # the serving path's peak, before the inverses and the float64 checks
    # allocate theirs
    peak = torch.cuda.max_memory_allocated()
    inverse = inverse_phase(torch, stt, ho, sess, ops, gen_m, b_rbt)
    launches = dict(ho.LAUNCHES)

    res = {name: [] for name in ops}
    operators = {"chol": spd, "lu": gen_m, "chol_nb128": spd, "nopiv": dom,
                 "lu_calu": gen_m}
    for name in operators:
        for xs, b in zip(served[name], rhs[name]):
            res[name] += scaled_residuals(torch, operators[name], xs, b)
    # qr: every served column against a float64 solve of the same problem
    # (the deciding check), plus the reference tester's gels bound
    for xs, b in zip(served["qr"], rhs["qr"]):
        check(xs.shape == (n_q, b.shape[1]), "qr solve shape")
    tall64 = tall.double()
    eps = torch.finfo(tall.dtype).eps
    b_all = torch.cat(rhs["qr"], dim=1)
    x_all = torch.cat(served["qr"], dim=1)
    ref = lstsq_normal64(torch, tall64, b_all)
    qr_rel = rel_errors(torch, x_all, ref)
    res["qr"] = gels_residuals(torch, tall64, eps, x_all, b_all)
    # the check must fail a wrong answer: x off by 1 % of its size, and a
    # random x of the right size
    noise = torch.randn(x_all.shape, generator=gen, device=dev)
    scale = x_all.abs().max(dim=0).values
    wrong = {"perturbed_1pct": x_all + 1e-2 * scale * noise,
             "random": scale * noise / noise.abs().max(dim=0).values}
    wrong_rel = {k: min(rel_errors(torch, x, ref)) for k, x in wrong.items()}
    wrong_res = {k: max(gels_residuals(torch, tall64, eps, x, b_all))
                 for k, x in wrong.items()}
    del tall64, ref

    check(all(v == 0 for v in info.values()), f"factor info {info}")
    nt = -(-n // nb)
    fl = factor_launches
    check(fl["chol"]["chol_tile"] >= nt,
          f"chol_tile launched {fl['chol']['chol_tile']} < {nt} times")
    k2 = fl["lu"]["lu_panel_base"]
    check(k2 >= nt, "lu_panel_base launched fewer than once per panel")
    if nb == 512:  # each (H, 512) panel splits into four 128-wide K2 bases
        check(k2 == 4 * nt, f"lu factor launched lu_panel_base {k2} times, "
              f"expected {4 * nt} for {nt} panels")
    kt = -(-n_q // nb)
    k3, k4 = fl["qr"]["qr_panel_base"], fl["qr"]["qr_panel_base_wide"]
    check(k3 + k4 >= kt, f"qr factor launched {fl['qr']} for {kt} panels")
    if nb == 512:  # each (H, 512) panel splits into four 128-wide K4 bases
        check(k4 == 4 * kt and k3 == 0,
              f"qr factor launched {fl['qr']}: expected {4 * kt} "
              f"qr_panel_base_wide and no qr_panel_base for {kt} panels")
    # the recursion's exact launches where they are known, else at least
    # one K5 and one K1
    k5_k1 = REC_POTRF_LAUNCHES.get(n)
    rec_fl = fl["chol_nb128"]
    got = (rec_fl["herk_lower_update"], rec_fl["chol_tile"])
    check((got == k5_k1 if k5_k1 else min(got) > 0)
          and rec_fl["lu_panel_base"] == rec_fl["qr_panel_base"]
          == rec_fl["qr_panel_base_wide"] == 0,
          f"nb = {nb_rec} chol factor launched {rec_fl}, expected "
          f"(herk_lower_update, chol_tile) = {k5_k1} and nothing else")
    res["rbt"] = scaled_residuals(torch, gen_m, inverse.pop("x_rbt"), b_rbt)
    for name, a in (("potri", spd), ("getri", gen_m)):
        inverse[name]["inverse_residual"] = r = inverse_residual(
            torch, a, inverse.pop(f"x_{name}"))
        check(math.isfinite(r) and r <= RESIDUAL_BOUND, f"{name}: ‖I − A·X‖₁ "
              f"/ (n·ε·‖A‖₁·‖X‖₁) = {r} > {RESIDUAL_BOUND}")
    check_p1_p2(n, nb, factor_launches, solve_launches, inverse, len(widths))
    worst = max(max(v) for v in res.values())
    check(math.isfinite(worst) and worst <= RESIDUAL_BOUND,
          f"scaled residual {worst} > {RESIDUAL_BOUND}")
    worst_rel = max(qr_rel)
    check(math.isfinite(worst_rel) and worst_rel <= QR_REL_LIMIT,
          f"qr solve: relative error {worst_rel} vs float64 > {QR_REL_LIMIT}")
    check(all(v > QR_REL_LIMIT for v in wrong_rel.values()),
          f"qr check passes a wrong answer: {wrong_rel}")
    solve_hist = sess.metrics.histogram("solve_latency")
    from slate_tpu_torch.obs import flops
    return {
        "n": n, "nb": nb, "dtype": "float32", "qr_shape": [m_q, n_q],
        "requests_per_operator": len(widths),
        "chol_factor_s": factor_s["chol"],
        "chol_gflops": flops.potrf(n) / factor_s["chol"] / 1e9,
        "lu_factor_s": factor_s["lu"],
        "lu_gflops": flops.getrf(n) / factor_s["lu"] / 1e9,
        "qr_factor_s": factor_s["qr"],
        "qr_gflops": flops.geqrf(m_q, n_q) / factor_s["qr"] / 1e9,
        "chol_nb128_nb": nb_rec,
        "chol_nb128_factor_s": factor_s["chol_nb128"],
        "chol_nb128_gflops": flops.potrf(n) / factor_s["chol_nb128"] / 1e9,
        "chol_nb128_expected_launches": k5_k1 and {
            "herk_lower_update": k5_k1[0], "chol_tile": k5_k1[1]},
        "nopiv_factor_s": factor_s["nopiv"],
        "nopiv_gflops": flops.getrf(n) / factor_s["nopiv"] / 1e9,
        # the same general operator by tournament pivoting, beside lu's
        "lu_calu_factor_s": factor_s["lu_calu"],
        "lu_calu_gflops": flops.getrf(n) / factor_s["lu_calu"] / 1e9,
        "lu_calu_over_lu_factor": factor_s["lu_calu"] / factor_s["lu"],
        **inverse,
        "solve_p50_s": solve_hist["p50"], "solve_p99_s": solve_hist["p99"],
        "solves": solve_hist["count"],
        "solve_latency_s": {k: {"p50": h.percentile(50),
                                "p99": h.percentile(99)}
                            for k, h in latency.items()},
        "max_memory_allocated": peak,
        "scaled_residual_max": {k: max(v) for k, v in res.items()},
        "qr_rel_err_max": worst_rel, "qr_rel_err_limit": QR_REL_LIMIT,
        "qr_wrong_answer_rel_err_min": wrong_rel,
        "qr_wrong_answer_scaled_residual_max": wrong_res,
        "residuals_checked": {k: len(v) for k, v in res.items()},
        "launches_factor": factor_launches,
        "launches_solves": solve_launches,
        "launches": launches,
        "metrics": sess.metrics.snapshot()["counters"],
        # for the serve phase, not printed
        "operands": {"spd": spd, "gen_m": gen_m, "tall": tall},
    }


# ---------------------------------------------------------------------------
# phase 5b: the serving front end (Executor, Batcher, solve graphs, faults)
# ---------------------------------------------------------------------------

SERVE_CLIENTS = 4
# per client and dense operator: single-vector requests, then 16-column
# blocks
SERVE_SINGLES, SERVE_BLOCKS, SERVE_BLOCK_COLS = 32, 2, 16
SERVE_TIMED = 16        # eager and graph-replayed solves timed per operator
SERVE_BIT_SAMPLE = 4    # served single-vector answers re-solved eagerly
SERVE_SMALL_OPS = 1000  # lu_small and chol_small operators each
SERVE_SMALL_BAD = (417, 100)  # (lu_small item, zeroed column)
SERVE_DRILL_FAULTS, SERVE_DRILL_REQUESTS = 3, 16
RESULT_TIMEOUT = 600.0  # seconds any one future may take


def serve_clients(ex, requests, clients=SERVE_CLIENTS):
    """``clients`` threads, client c submitting ``requests[c::clients]``
    ((handle, b) with host arrays) through ``ex`` and then waiting for each
    result (RESULT_TIMEOUT). Returns, in request order, the answer or the
    exception of each, the seconds from its submit to its resolution
    (taken in the resolving thread), and the wall of the whole."""
    import threading
    answers = [None] * len(requests)
    latency = [None] * len(requests)
    failures = []

    def client(c):
        try:
            futs = []
            for i in range(c, len(requests), clients):
                t0 = time.perf_counter()
                f = ex.submit(*requests[i])
                f.add_done_callback(
                    lambda _, i=i, t0=t0: latency.__setitem__(
                        i, time.perf_counter() - t0))
                futs.append((i, f))
            for i, f in futs:
                err = f.exception(timeout=RESULT_TIMEOUT)
                answers[i] = err if err is not None else f.result()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failures.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if failures:
        raise failures[0]
    return answers, latency, wall


def eager_solve(stt, op, payload, B):
    """The *_solve_using_factor verb of ``op`` on a resident payload (an
    appended qr resident's: ``appended_gels`` of its 5-tuple)."""
    if op == "lu":
        return stt.lu_solve_using_factor(*payload, B)
    if op == "qr" and len(payload) > 1:
        from slate_tpu_torch.linalg.update import appended_gels
        return appended_gels(payload, B)
    if op == "qr":
        return stt.least_squares_solve_using_factor(payload[0], B)
    return stt.chol_solve_using_factor(payload[0], B)


def serve_dense(torch, stt, ho, main, operands, n, nb, seed):
    """The dense operators of the main phase under a fresh Session and an
    Executor: warmup (factor + graph capture) of each, SERVE_CLIENTS
    client threads of requests, the gate on every served column,
    graph-replayed against eager bits, eager against graph-replayed solve
    times, and the fault drill."""
    import numpy as np
    from slate_tpu_torch.runtime.metrics import Histogram
    dev = "cuda"
    spd, gen_m, tall = operands["spd"], operands["gen_m"], operands["tall"]
    n_q = tall.shape[1]
    sess = stt.Session(hbm_budget=16 << 30, device=dev)
    ops = {"chol": sess.register(stt.hermitian(spd, nb, stt.Uplo.Lower,
                                               device=dev), op="chol"),
           "lu": sess.register(stt.from_dense(gen_m, nb, device=dev),
                               op="lu"),
           "qr": sess.register(stt.from_dense(tall, nb, device=dev),
                               op="qr"),
           "chol_nb128": sess.register(stt.hermitian(
               spd, n // 128, stt.Uplo.Lower, device=dev), op="chol")}
    a_of = {"chol": spd, "lu": gen_m, "qr": tall, "chol_nb128": spd}
    kernels = ("chol_tile", "lu_panel_base", "qr_panel_base",
               "qr_panel_base_wide", "herk_lower_update")
    m = sess.metrics
    out = {"n": n, "nb": nb, "dtype": "float32", "qr_shape": [2 * n, n_q],
           "clients": SERVE_CLIENTS, "max_batch": 32, "max_wait_s": 2e-3,
           "warmup": {}}
    with stt.Executor(sess, max_batch=32, max_wait=2e-3) as ex:
        for name, h in ops.items():
            compiles = m.get("aot_compiles")
            before = dict(ho.LAUNCHES)
            t0 = time.perf_counter()
            ex.warmup([h])
            wall = time.perf_counter() - t0
            got = {k: ho.LAUNCHES[k] - before[k] for k in ho.LAUNCHES}
            res = sess.factor(h)
            out["warmup"][name] = {
                "wall_s": wall, "aot_compiles": m.get("aot_compiles"),
                "captured": m.get("aot_compiles") - compiles,
                "graph_bytes": sum(g.nbytes for g in res.graphs.values()),
                "launches": {k: v for k, v in got.items() if v}}
            check(res.info == 0 and len(res.graphs) == 1,
                  f"serve warmup {name}: info {res.info}, "
                  f"{len(res.graphs)} graphs")
            # the factor launches the main phase's factor of the same
            # operator made; P1: the factor's, the eager run and the capture
            fl = main["launches_factor"][name]
            p1 = (fl["trtri_leaves"] + 2 * main["launches_solves"][name]
                  ["trtri_leaves"] // main["requests_per_operator"])
            check(all(got[k] == fl[k] for k in kernels)
                  and got["trtri_leaves"] == p1,
                  f"serve warmup {name} launched {got}, expected the main "
                  f"factor's {fl} and {p1} trtri_leaves")
        check(m.get("aot_compiles") == len(ops),
              f"serve: {m.get('aot_compiles')} captures for {len(ops)} "
              "warmed operators")

        # the requests: per client and operator SERVE_SINGLES vectors and
        # SERVE_BLOCKS 16-column blocks, interleaved across the operators
        requests, meta = [], []
        for c in range(SERVE_CLIENTS):
            rng = np.random.default_rng([seed, c])
            per_op = []
            for name, h in ops.items():
                rows = 2 * n if name == "qr" else n
                mine = [rng.standard_normal(rows, dtype=np.float32)
                        for _ in range(SERVE_SINGLES)]
                mine += [rng.standard_normal((rows, SERVE_BLOCK_COLS),
                                             dtype=np.float32)
                         for _ in range(SERVE_BLOCKS)]
                per_op.append([(name, h, b) for b in mine])
            for reqs in itertools.zip_longest(*per_op):
                for r in reqs:
                    if r is not None:
                        meta.append(r[0])
                        requests.append(r[1:])
        counters0 = dict(m.snapshot()["counters"])
        before = dict(ho.LAUNCHES)
        answers, latency, wall = serve_clients(
            ex, [(h, b) for h, b in requests])
        counters = m.snapshot()["counters"]
        delta = {k: v - counters0.get(k, 0) for k, v in counters.items()}
        req_launches = {k: ho.LAUNCHES[k] - before[k] for k in ho.LAUNCHES}
    bad = [a for a in answers if isinstance(a, BaseException)]
    check(not bad, f"serve: {len(bad)} requests failed: {bad[:2]}")
    check(delta["completed_requests"] == delta["requests_total"]
          == len(requests)
          and delta["batches_total"] < delta["requests_total"],
          f"serve: counters {delta} for {len(requests)} requests")
    # every batch fits its warmed graph's padded width: each dispatch is a
    # replay, and a replay launches nothing through the wrappers
    check(delta.get("graph_replays", 0) == delta["dispatches_total"]
          and not any(req_launches.values()),
          f"serve: {delta.get('graph_replays', 0)} replays of "
          f"{delta['dispatches_total']} dispatches, launches {req_launches}")
    lat = {name: Histogram() for name in ops}
    for name, s in zip(meta, latency):
        lat[name].observe(s)
    out.update(requests=len(requests), wall_s=wall,
               requests_per_s=len(requests) / wall,
               counters=delta,
               request_latency_s={k: {"p50": v.percentile(50),
                                      "p99": v.percentile(99),
                                      "count": v.count}
                                  for k, v in lat.items()},
               metrics_request_latency=m.histogram("request_latency"))

    # the gate on every served column, and served answers against eager
    # solves of their own right-hand side on the same resident factor
    gate, bits = {}, {}
    for name, h in ops.items():
        idx = [i for i, k in enumerate(meta) if k == name]
        bcols = [requests[i][1].reshape(requests[i][1].shape[0], -1)
                 for i in idx]
        xcols = [answers[i].reshape(answers[i].shape[0], -1) for i in idx]
        B = torch.from_numpy(np.concatenate(bcols, axis=1)).to(dev)
        X = torch.from_numpy(np.concatenate(xcols, axis=1)).to(dev)
        if name == "qr":
            tall64 = tall.double()
            rel = rel_errors(torch, X, lstsq_normal64(torch, tall64, B))
            del tall64
            gate[name] = {"worst_rel_err": max(rel), "limit": QR_REL_LIMIT,
                          "columns": len(rel)}
            ok = max(rel) <= QR_REL_LIMIT
        else:
            r = scaled_residuals(torch, a_of[name], X, B, in_wide=True)
            gate[name] = {"worst_scaled_residual": max(r),
                          "limit": RESIDUAL_BOUND, "columns": len(r)}
            ok = max(r) <= RESIDUAL_BOUND
        check(ok, f"serve {name}: {gate[name]}")
        payload = sess.factor(h).payload
        same = []
        for i in idx[:SERVE_BIT_SAMPLE]:
            b = torch.from_numpy(requests[i][1][:, None]).to(dev)
            xe = eager_solve(stt, name, payload,
                             stt.from_dense(b, sess._ops[h].A.nb,
                                            device=dev)).to_numpy()[:, 0]
            same.append(bool(np.array_equal(xe.view(np.int32),
                                            answers[i].view(np.int32))))
        bits[name] = {"served_vs_eager_bitwise": same}
    out["gate"] = gate

    # eager against graph-replayed solves of one column, timed, and their
    # bits; the replays launch nothing through the wrappers
    timing = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, h in ops.items():
        rows = 2 * n if name == "qr" else n
        B = stt.from_dense(torch.randn((rows, 1), generator=gen, device=dev),
                           sess._ops[h].A.nb, device=dev)
        payload = sess.factor(h).payload
        he, hg = Histogram(), Histogram()
        before = dict(ho.LAUNCHES)
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            xe = eager_solve(stt, name, payload, B)
            torch.cuda.synchronize()
            he.observe(time.perf_counter() - t0)
        eager_p1 = ho.LAUNCHES["trtri_leaves"] - before["trtri_leaves"]
        before = dict(ho.LAUNCHES)
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            xg = sess.solve_matrix(h, B)  # ends in a device sync
            hg.observe(time.perf_counter() - t0)
        graph_launches = sum(ho.LAUNCHES[k] - before[k] for k in ho.LAUNCHES)
        p1 = SERVE_TIMED * main["launches_solves"][name]["trtri_leaves"] \
            // main["requests_per_operator"]
        check(eager_p1 == p1 and graph_launches == 0,
              f"serve {name}: the eager solves launched {eager_p1} "
              f"trtri_leaves (expected {p1}), the replays {graph_launches} "
              "kernels")
        equal = torch.equal(xe.dense(), xg.dense())
        bits[name]["graph_vs_eager_bitwise"] = equal
        if not equal:
            bits[name]["max_abs_diff"] = float(
                (xe.dense() - xg.dense()).abs().max())
        timing[name] = {"eager_p50_s": he.percentile(50),
                        "eager_p99_s": he.percentile(99),
                        "graph_p50_s": hg.percentile(50),
                        "graph_p99_s": hg.percentile(99),
                        "eager_p1_launches": eager_p1}
    out["solve_timing"] = timing
    out["bits"] = bits
    out["graph_equals_eager_bitwise"] = all(
        v["graph_vs_eager_bitwise"] and all(v["served_vs_eager_bitwise"])
        for v in bits.values())
    check(out["graph_equals_eager_bitwise"],
          f"serve: graph-replayed or served answers differ from the eager "
          f"*_solve_using_factor bits: {bits}")

    # the fault drill: the first SERVE_DRILL_FAULTS dispatches fail
    # (requests against the chol operator only), one retry each bucket,
    # the breaker opens at the first exhausted bucket
    sess.enable_faults(stt.FaultPlan(seed=seed, specs=(stt.FaultSpec(
        "dispatch_error", rate=1.0, count=SERVE_DRILL_FAULTS),)))
    rng = np.random.default_rng([seed, 99])
    drill_b = [rng.standard_normal(n, dtype=np.float32)
               for _ in range(SERVE_DRILL_REQUESTS)]
    counters0 = dict(m.snapshot()["counters"])
    with stt.Executor(sess, max_batch=8, max_wait=2e-3, retries=1,
                      backoff_base=1e-3, breaker_threshold=1,
                      breaker_cooldown=0.05) as ex:
        answers, _, _ = serve_clients(
            ex, [(ops["chol"], b) for b in drill_b], clients=1)
    sess.faults = None
    counters = m.snapshot()["counters"]
    delta = {k: v - counters0.get(k, 0) for k, v in counters.items()}
    failed = [a for a in answers if isinstance(a, BaseException)]
    served = [(a, b) for a, b in zip(answers, drill_b)
              if not isinstance(a, BaseException)]
    if served:
        X = torch.from_numpy(np.stack([a for a, _ in served], 1)).to(dev)
        B = torch.from_numpy(np.stack([b for _, b in served], 1)).to(dev)
        worst = max(scaled_residuals(torch, spd, X, B, in_wide=True))
        check(worst <= RESIDUAL_BOUND, f"serve drill: residual {worst}")
    drill = {"submitted": len(drill_b), "completed": len(served),
             "failed": len(failed),
             "errors": sorted({type(e).__name__ for e in failed}),
             **{k: delta.get(k, 0) for k in (
                 "faults_injected_total", "retries", "breaker_trips_total",
                 "degraded_dispatches_total", "breaker_short_circuits",
                 "breaker_probes_total", "breaker_closes_total",
                 "completed_requests", "failed_requests_total",
                 "requests_total")}}
    check(drill["completed"] + drill["failed"] == drill["submitted"]
          == drill["completed_requests"] + drill["failed_requests_total"]
          == drill["requests_total"]
          and drill["faults_injected_total"] == SERVE_DRILL_FAULTS
          and drill["breaker_trips_total"] >= 1
          and drill["degraded_dispatches_total"] >= 1,
          f"serve fault drill: {drill}")
    out["fault_drill"] = drill
    out["metrics"] = m.snapshot()["counters"]
    return out


def serve_small(torch, stt, gen, seed):
    """SERVE_SMALL_OPS lu_small and as many chol_small operators at
    n = 256 (k = 2, float32) under one Session, each served one request
    through an Executor by SERVE_CLIENTS client threads; one lu_small
    operator is singular (a zero column) and must fail alone."""
    import numpy as np
    dev, n, k = "cuda", SESSION_N, SMALL_RHS
    item, col = SERVE_SMALL_BAD
    a_lu = torch.randn((SERVE_SMALL_OPS, n, n), generator=gen, device=dev)
    a_lu[item, :, col] = 0
    a_ch = torch.randn((SERVE_SMALL_OPS, n, n), generator=gen, device=dev)
    a_ch = a_ch @ a_ch.mT / n + torch.eye(n, device=dev)
    sess = stt.Session(device=dev)
    hs = ([sess.register(a, op="lu_small") for a in a_lu]
          + [sess.register(a, op="chol_small") for a in a_ch])
    rhs = np.random.default_rng([seed, 7]).standard_normal(
        (len(hs), n, k), dtype=np.float32)
    # lu and chol requests interleaved
    order = [i for pair in zip(range(SERVE_SMALL_OPS),
                               range(SERVE_SMALL_OPS, len(hs)))
             for i in pair]
    with stt.Executor(sess, max_batch=32, max_wait=2e-3) as ex:
        answers, latency, wall = serve_clients(
            ex, [(hs[i], rhs[i]) for i in order])
    by_op = dict(zip(order, answers))
    lat = dict(zip(order, latency))
    err = by_op[item]
    check(isinstance(err, stt.SlateError) and f"info={col + 1}" in str(err),
          f"serve small: the singular operator gave {err!r}")
    others = [i for i in range(len(hs)) if i != item]
    bad = [i for i in others if isinstance(by_op[i], BaseException)]
    check(not bad, f"serve small: operators {bad[:4]} failed too")
    worst = {}
    for name, a, ids in (("lu_small", a_lu, range(SERVE_SMALL_OPS)),
                         ("chol_small", a_ch,
                          range(SERVE_SMALL_OPS, len(hs)))):
        keep = [i for i in ids if i != item]
        x = torch.from_numpy(np.stack([by_op[i] for i in keep])).to(dev)
        b = torch.from_numpy(rhs[keep]).to(dev)
        worst[name] = batched_residuals(
            torch, a[[i - ids[0] for i in keep]], x, b).max().item()
        check(worst[name] <= RESIDUAL_BOUND,
              f"serve small {name}: worst scaled residual {worst[name]}")
    # grouped against per-request bits, printed (ROADMAP queue 3: the
    # batched gemms differ on the card)
    sample = [i for i in range(8) if i != item] + list(
        range(SERVE_SMALL_OPS, SERVE_SMALL_OPS + 8))
    same = [bool(np.array_equal(sess.solve(hs[i], rhs[i]).view(np.int32),
                                by_op[i].view(np.int32))) for i in sample]
    c = sess.metrics.snapshot()["counters"]
    lh = sorted(lat.values())
    return {"n": n, "k": k, "operators": len(hs), "requests": len(hs),
            "wall_s": wall, "requests_per_s": len(hs) / wall,
            "request_latency_p50_s": lh[len(lh) // 2],
            "request_latency_p99_s": lh[min(len(lh) - 1,
                                            round(0.99 * (len(lh) - 1)))],
            "batches_total": c["batches_total"],
            "worst_scaled_residual": worst, "gate": RESIDUAL_BOUND,
            "singular": {"item": item, "error": str(err)},
            "grouped_equals_per_request_bitwise": same,
            "counters": c}


def serve_phase(torch, stt, ho, main, operands, n, nb, seed, gen):
    """The serving front end on the card: ``serve_dense`` on the main
    phase's operators and ``serve_small``."""
    t0 = time.perf_counter()
    out = serve_dense(torch, stt, ho, main, operands, n, nb, seed)
    out["small"] = serve_small(torch, stt, gen, seed)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 6: the batched small-problem engine
# ---------------------------------------------------------------------------

# the ends of the reference's own bench_batched (bench_serve.py:662):
# float32, (n, B) = (256, 1000) and (32, 10000), 2 right-hand sides (:689)
SMALL_RUNS = ((256, 1000), (32, 10000))
SMALL_RHS = 2
PER_REQUEST_SAMPLE = 64  # B = 1 calls timed per verb, as bench_serve.py
SESSION_N, SESSION_B, SESSION_REQUESTS = 256, 1000, 8
SESSION_FAULT = (417, 100)  # (item, column or pivot) of the fault runs
# kernel launches of one batched call at the default nb (32): blocked.py's
# recursions (a 64-row trsm base is two P1 leaves of 32)
SMALL_LAUNCHES = {
    ("gesv", 256): {"lu_panel_batched": 8, "trtri_leaves": 7 + 16},
    ("posv", 256): {"chol_tile_batched": 8, "trtri_leaves": 7 + 16},
    ("gels", 256): {"qr_panel_batched": 8, "trtri_leaves": 8 + 8},
    ("gesv", 32): {"lu_panel_batched": 1, "trtri_leaves": 2},
    ("posv", 32): {"chol_tile_batched": 1, "trtri_leaves": 2},
    ("gels", 32): {"qr_panel_batched": 1, "trtri_leaves": 1 + 1},
    ("lu_small", "factor"): {"lu_panel_batched": 8, "trtri_leaves": 7},
    ("chol_small", "factor"): {"chol_tile_batched": 8, "trtri_leaves": 7},
    ("lu_small", "solve"): {"trtri_leaves": 16},
    ("chol_small", "solve"): {"trtri_leaves": 16},
}


def launches_of(ho, fn):
    """``fn()``'s result, its wall in s (host clock between two device
    syncs) and the kernel launches it made (the nonzero counts)."""
    import torch
    before = dict(ho.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: v - before[k] for k, v in ho.LAUNCHES.items()
                       if v != before[k]}


def batched_residuals(torch, a, x, b):
    """Per item max over columns of ‖b − A·x‖∞ / (n·ε·‖A‖∞·‖x‖∞) in
    float64 (complex128 for a complex A), ε of A's type."""
    eps = torch.finfo(a.dtype).eps
    a64, x64 = wide(torch, a), wide(torch, x)
    r = (wide(torch, b) - a64 @ x64).abs().amax(dim=1)
    anorm = a64.abs().sum(dim=2).amax(dim=1)
    return (r / (a.shape[1] * eps * anorm[:, None]
                 * x64.abs().amax(dim=1))).amax(dim=1)


def batched_lstsq_rel(torch, a, x, b):
    """Per item max over columns of ‖x − x₆₄‖∞ / ‖x₆₄‖∞, x₆₄ the float64
    (complex128 for complex items) normal-equations solution (κ ≈ 3 for a
    2:1 Gaussian), as the main path's qr check."""
    a64 = wide(torch, a)
    chol = torch.linalg.cholesky(a64.mH @ a64)
    ref = torch.cholesky_solve(a64.mH @ wide(torch, b), chol)
    return ((wide(torch, x) - ref).abs().amax(dim=1)
            / ref.abs().amax(dim=1)).amax(dim=1)


def small_verb_run(torch, stt, ho, verb, n, bsz, gen, dtype=None):
    """One verb at (n, B): a warm call, then the batched call timed (wall,
    requests per second, launches pinned to SMALL_LAUNCHES), every item
    under its gate (gesv/posv: the scaled residual ≤ 30 in float64; gels:
    within QR_REL_LIMIT of a float64 solve), a PyTorch call for the same
    function timed beside it, and PER_REQUEST_SAMPLE items served one at a
    time (B = 1): their wall, their gate, and whether each equals its lane
    of the batched call bit for bit, with 2 right-hand sides and with one
    (a vector). ``dtype``: float32 unless given (complex: the gate in
    complex128, posv's items Hermitian)."""
    dtype = dtype or torch.float32
    m = 2 * n if verb == "gels" else n
    a = torch.randn((bsz, m, n), generator=gen, device="cuda", dtype=dtype)
    if verb == "posv":
        a = a @ a.mH / n + torch.eye(n, device="cuda", dtype=dtype)
    b = torch.randn((bsz, m, SMALL_RHS), generator=gen, device="cuda",
                    dtype=dtype)
    fn = getattr(stt, f"{verb}_batched")
    fn(a, b)  # warm: cuBLAS handles and workspaces
    (x, info), wall, launches = launches_of(ho, lambda: fn(a, b))
    name = f"small {verb} (n={n}, B={bsz}, {dtype_name(dtype)})"
    check(launches == SMALL_LAUNCHES[(verb, n)],
          f"{name}: launches {launches}, expected "
          f"{SMALL_LAUNCHES[(verb, n)]}")
    check(not info.any(), f"{name}: info {int(info.count_nonzero())} items")
    lib = {"gesv": lambda: torch.linalg.solve(a, b),
           "posv": lambda: torch.cholesky_solve(
               b, torch.linalg.cholesky(a)),
           "gels": lambda: torch.linalg.lstsq(a, b).solution}[verb]
    lib()
    _, lib_wall, _ = launches_of(ho, lib)
    sample = range(PER_REQUEST_SAMPLE)
    t0 = time.perf_counter()
    singles = [fn(a[i:i + 1], b[i:i + 1])[0][0] for i in sample]
    torch.cuda.synchronize()
    per_request_wall = time.perf_counter() - t0
    xs1 = torch.stack(singles)
    bitwise = all(torch.equal(x[i], xs1[i]) for i in sample)
    xv, _ = fn(a[:PER_REQUEST_SAMPLE], b[:PER_REQUEST_SAMPLE, :, 0])
    vec_bitwise = all(torch.equal(xv[i], fn(a[i:i + 1], b[i:i + 1, :, 0])[0][0])
                      for i in range(16))
    if verb == "gels":
        gate = batched_lstsq_rel(torch, a, x, b)
        gate1 = batched_lstsq_rel(torch, a[:PER_REQUEST_SAMPLE],
                                  xs1, b[:PER_REQUEST_SAMPLE])
        limit = QR_REL_LIMIT
    else:
        gate = batched_residuals(torch, a, x, b)
        gate1 = batched_residuals(torch, a[:PER_REQUEST_SAMPLE], xs1,
                                  b[:PER_REQUEST_SAMPLE])
        limit = RESIDUAL_BOUND
    worst = max(gate.max().item(), gate1.max().item())
    check(math.isfinite(worst) and worst <= limit,
          f"{name}: worst item {worst} > {limit}")
    return {"verb": verb, "n": n, "B": bsz, "m": m, "k": SMALL_RHS,
            "dtype": dtype_name(dtype), "wall_s": wall,
            "req_per_s": bsz / wall,
            "launches": launches,
            "library_s": lib_wall, "library_req_per_s": bsz / lib_wall,
            "per_request_sample": PER_REQUEST_SAMPLE,
            "per_request_wall_s": per_request_wall,
            "per_request_req_per_s": PER_REQUEST_SAMPLE / per_request_wall,
            "per_request_bitwise": bitwise,
            "vector_rhs_per_request_bitwise": vec_bitwise,
            ("worst_rel_err" if verb == "gels" else "worst_scaled_residual"):
                worst, "gate": limit, "items_checked": bsz
            + PER_REQUEST_SAMPLE}


def small_session_run(torch, stt, ho, op, mats, rhs, fault=None):
    """A Session with one ``op`` operator per item of ``mats``: one
    solve_small_batched over all of them with every factor a miss (one
    batched factor, one batched solve), again with every factor resident,
    then SESSION_REQUESTS per-request solves; walls, launches (pinned),
    the counters, and each per-request answer against its grouped lane
    bit for bit."""
    import numpy as np
    sess = stt.Session(device="cuda")
    hs = [sess.register(m, op=op) for m in mats]
    (xs, infos), cold, cold_launches = launches_of(
        ho, lambda: sess.solve_small_batched(hs, rhs))
    want = {k: SMALL_LAUNCHES[(op, "factor")].get(k, 0)
            + SMALL_LAUNCHES[(op, "solve")].get(k, 0)
            for k in ("lu_panel_batched", "chol_tile_batched",
                      "trtri_leaves")}
    check(cold_launches == {k: v for k, v in want.items() if v},
          f"session {op}: cold launches {cold_launches}, expected {want}")
    out = {"op": op, "n": SESSION_N, "operators": len(hs), "k": SMALL_RHS,
           "cold_s": cold, "cold_req_per_s": len(hs) / cold,
           "cold_launches": cold_launches}
    if fault is None:
        (xs_hot, _), hot, hot_launches = launches_of(
            ho, lambda: sess.solve_small_batched(hs, rhs))
        check(hot_launches == SMALL_LAUNCHES[(op, "solve")],
              f"session {op}: hot launches {hot_launches}")
        per, same = [], []
        for i in range(SESSION_REQUESTS):
            t0 = time.perf_counter()
            xi = sess.solve(hs[i], rhs[i])
            per.append(time.perf_counter() - t0)
            same.append(np.array_equal(xi.view(np.int32),
                                       xs_hot[i].view(np.int32)))
        out.update({"hot_s": hot, "hot_req_per_s": len(hs) / hot,
                    "hot_launches": hot_launches,
                    "per_request_s": per,
                    "grouped_equals_per_request_bitwise": all(same),
                    "cold_equals_hot_bitwise": np.array_equal(
                        xs.view(np.int32), xs_hot.view(np.int32))})
    out["counters"] = sess.metrics.snapshot()["counters"]
    return out, xs, infos


def small_phase(torch, stt, ho, gen, dtype=None,
                verb_names=("gesv", "posv", "gels")):
    """The batched verbs at both ends of bench_batched and the Session's
    small ops at n = 256, B = 1000, with their fault runs, in float32
    unless ``dtype`` is given."""
    import numpy as np
    dtype = dtype or torch.float32
    verbs = [small_verb_run(torch, stt, ho, verb, n, bsz, gen, dtype)
             for n, bsz in SMALL_RUNS for verb in verb_names]
    sessions = []
    item, col = SESSION_FAULT
    for op in ("lu_small", "chol_small"):
        a = torch.randn((SESSION_B, SESSION_N, SESSION_N), generator=gen,
                        device="cuda", dtype=dtype)
        if op == "chol_small":
            a = a @ a.mH / SESSION_N + torch.eye(SESSION_N, device="cuda",
                                                 dtype=dtype)
        b = torch.randn((SESSION_B, SESSION_N, SMALL_RHS), generator=gen,
                        device="cuda", dtype=dtype)
        rhs = list(b)
        run, xs, infos = small_session_run(torch, stt, ho, op, list(a), rhs)
        check(not any(infos), f"session {op}: infos {set(infos)}")
        res = batched_residuals(torch, a, torch.from_numpy(xs).cuda(), b)
        run["worst_scaled_residual"] = res.max().item()
        check(run["worst_scaled_residual"] <= RESIDUAL_BOUND,
              f"session {op}: worst scaled residual "
              f"{run['worst_scaled_residual']}")
        # one bad operator among the same ones: only its info, and every
        # other lane bit for bit as without it
        bad = a.clone()
        if op == "lu_small":
            bad[item, :, col] = 0
        else:
            bad[item, col, col] = -1.0
        frun, fxs, finfos = small_session_run(torch, stt, ho, op,
                                              list(bad), rhs, fault=True)
        want = [0] * SESSION_B
        want[item] = col + 1
        keep = [i for i in range(SESSION_B) if i != item]
        check(finfos == want and np.array_equal(fxs[keep].view(np.int32),
                                                xs[keep].view(np.int32)),
              f"session {op} fault run: infos at "
              f"{[(i, v) for i, v in enumerate(finfos) if v]}, or a "
              "neighbour changed")
        run["fault"] = {"item": item, "info": finfos[item],
                        "neighbours_bitwise": True, "cold_s": frun["cold_s"],
                        "counters": frun["counters"]}
        run["dtype"] = dtype_name(dtype)
        sessions.append(run)
    return {"verbs": verbs, "sessions": sessions}


# ---------------------------------------------------------------------------
# phase 7: complex64 and complex128 through the LU and Cholesky paths
# ---------------------------------------------------------------------------

def complex_kernel_rows(torch, ho, gen, n):
    """The complex instances of K1-K4 and P2-P5 against their plain
    versions at the real rows' shapes, in complex64 and complex128, each
    with the fault cases of its real rows (one "kernel" line per kernel,
    "dtype": "complex"). Returns each kernel's timed rows for the kernels
    line, under "at_<dtype>_<shape>"."""
    c64, c128 = torch.complex64, torch.complex128
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "plan")
    out = {}

    def keep(name, rows, shape):
        out[name] = {f"at_{r['dtype']}_" + "x".join(str(r[k]) for k in shape):
                     {k: r[k] for k in keys if k in r}
                     for r in rows if "ms" in r}

    # K1 at b = 128 and 512 (one CTA or a resident cluster in complex64,
    # a resident and a streaming cluster in complex128), non-positive
    # real pivots with an imaginary part on them
    rows = [chol_case(torch, ho, b, dt, gen, timed=True)
            for dt in (c64, c128) for b in (128, 512)]
    rows += [chol_case(torch, ho, b, dt, gen, timed=False)
             for b, dt in ((33, c64), (1024, c64), (200, c128))]
    keep("chol_tile", rows, ("b",))
    emit("kernel", name="chol_tile", dtype="complex", cases=rows,
         nan_cases=[chol_nan_case(torch, ho, gen, c64, [(512, 300),
                                                         (128, 0)]),
                    chol_nan_case(torch, ho, gen, c128, [(512, 20),
                                                          (128, 70)])])
    # K2 at the main path's tallest base (resident slabs in complex64,
    # streaming in complex128), a zero column, ragged slabs, and the tie
    # and inf + nan·i across slabs
    rows = [lu_case(torch, ho, n, 128, dt, gen, timed=True)
            for dt in (c64, c128)]
    rows += [lu_case(torch, ho, hh, w, dt, gen, timed=False)
             for hh, w, dt in ((1000, 100, c64), (4096, 128, c128),
                               (256, 4, c128))]
    rows.append(lu_case(torch, ho, 1024, 64, c64, gen, False, zero_col=10))
    keep("lu_panel_base", rows, ("H", "w"))
    emit("kernel", name="lu_panel_base", dtype="complex", cases=rows,
         edge_cases=[lu_edge_case(torch, ho, gen, dt) for dt in (c64, c128)])
    # P2 at 64² (timed), a zero pivot at step 20, a NaN, in place on a
    # strided and a transposed view with signed zeros
    rows = [lu_nopiv_case(torch, ho, 64, dt, gen, timed=True)
            for dt in (c64, c128)]
    rows += [lu_nopiv_case(torch, ho, 64, dt, gen, zero_at=20)
             for dt in (c64, c128)]
    rows += [lu_nopiv_case(torch, ho, 33, c128, gen, nan_at=(5, 3)),
             lu_nopiv_case(torch, ho, 64, c64, gen, view="strided",
                           signed_zeros=True),
             lu_nopiv_case(torch, ho, 17, c128, gen, view="t",
                           signed_zeros=True)]
    keep("lu_nopiv_base", rows, ("s", "s"))
    emit("kernel", name="lu_nopiv_base", dtype="complex", cases=rows)
    # P3 at the CALU round (32, 512, 512) (resident in complex64,
    # streaming in complex128) and the engine's (10000, 32, 32), timed;
    # the faults
    rows = [lu_batched_case(torch, ho, bsz, hh, w_, dt, gen, timed=True)
            for bsz, hh, w_ in ((32, 512, 512), (10000, 32, 32))
            for dt in (c64, c128)]
    rows += [lu_batched_case(torch, ho, bsz, hh, w_, dt, gen, fault=fault)
             for bsz, hh, w_, dt, fault in (
                 (3, 777, 129, c128, None),
                 (8, 512, 512, c64, "zero_column"),
                 (4, 1000, 64, c128, "nan"), (4, 1000, 64, c64, "nan"),
                 (4, 300, 40, c64, "tie"), (4, 300, 40, c128, "tie"))]
    keep("lu_panel_batched", rows, ("B", "H", "w"))
    emit("kernel", name="lu_panel_batched", dtype="complex", cases=rows)
    # P4 at the engine's tiles (timed): the diagonal blocks of a
    # (1000, 256, 256) stack and (10000, 32, 32); non-positive pivots,
    # s = 48 and 64 (complex128 at 64 holds 96 entries a lane: it spills)
    rows = [chol_batched_case(torch, ho, bsz, 32, dt, gen, timed=True,
                              n_big=n_big)
            for bsz, n_big in ((1000, 256), (10000, None))
            for dt in (c64, c128)]
    rows += [chol_batched_case(torch, ho, bsz, s_, dt, gen, n_big=n_big,
                               faults=faults)
             for bsz, s_, dt, n_big, faults in (
                 (1000, 32, c128, 256, (0, 20, 31)),
                 (1000, 32, c64, None, (0, 20, 31)),
                 (64, 64, c128, 128, (0, 20, 63)),
                 (5, 48, c64, None, (47,)), (7, 16, c128, None, (3,)),
                 (3, 1, c64, None, (0,)))]
    keep("chol_tile_batched", rows, ("B", "s", "s"))
    emit("kernel", name="chol_tile_batched", dtype="complex", cases=rows)
    # K3 at gels' nb = 32 panel (2n, 32), resident in both types; K4 at
    # the qr operator's first base (2n, 128), streaming in both, at
    # (8192, 128), resident in both, and in complex128 at (10000, 128),
    # which streams (its slab and K4's own 91,776 B exceed a block's
    # shared memory); ragged panels, a zero column, the zero tails under
    # an alpha with an imaginary part, a NaN
    rows = [qr_case(torch, ho, 2 * n, 32, dt, gen, timed=True)
            for dt in (c64, c128)]
    rows += [qr_case(torch, ho, hh, w_, dt, gen, timed=False)
             for hh, w_, dt in ((1000, 20, c64), (4096, 32, c128),
                                (256, 4, c64), (20000, 32, c128))]
    rows.append(qr_case(torch, ho, 1024, 32, c128, gen, False, zero_col=10))
    keep("qr_panel_base", rows, ("H", "w"))
    emit("kernel", name="qr_panel_base", dtype="complex", cases=rows)
    rows = [qr_case(torch, ho, hh, 128, dt, gen, timed=True)
            for hh, dt in ((2 * n, c64), (2 * n, c128), (8192, c64),
                           (8192, c128), (10000, c128))]
    rows += [qr_case(torch, ho, hh, w_, dt, gen, timed=False)
             for hh, w_, dt in ((1000, 96, c64), (20000, 64, c128),
                                (256, 128, c128))]
    rows.append(qr_case(torch, ho, 1024, 128, c64, gen, False, zero_col=37))
    check_plan_modes("qr_panel_base_wide", rows)
    keep("qr_panel_base_wide", rows, ("H", "w"))
    emit("kernel", name="qr_panel_base_wide", dtype="complex", cases=rows,
         nan_cases=[qr_nan_case(torch, ho, gen, dt) for dt in (c64, c128)],
         zero_tail_cases=[qr_zero_tail_case(torch, ho, gen, dt)
                          for dt in (c64, c128)])
    # P5 at the engine's panels (timed): the first of gels at
    # (1000, 512, 256) as a strided view, (10000, 64, 32), and the
    # streaming (8, 2000, 128); complex64 takes float64's plans, complex128
    # never registers; the faults and each side of every plan boundary
    rows = [qr_batched_case(torch, ho, bsz, hh, w_, dt, gen, timed=True,
                            strided=bsz == 1000)
            for bsz, hh, w_ in ((1000, 512, 32), (10000, 64, 32),
                                (8, 2000, 128))
            for dt in (c64, c128)]
    rows += [qr_batched_case(torch, ho, bsz, hh, w_, dt, gen, fault=fault)
             for bsz, hh, w_, dt, fault in (
                 (16, 256, 32, c64, "zero_column"),
                 (16, 256, 32, c128, "zero_column"),
                 (16, 256, 32, c64, "nan"), (4, 40, 40, c128, "nan"),
                 (5, 7, 7, c128, None), (3, 100, 1, c64, None))]
    rows += [qr_batched_case(torch, ho, 6, hh, w_, dt, gen)
             for hh, w_, dt in p5_boundary_shapes(torch, ho, (c64, c128))]
    check({r["plan"]["storage"] for r in rows}
          == {"registers", "shared", "streaming"},
          "complex qr_panel_batched: the cases did not cover every plan")
    keep("qr_panel_batched", rows, ("B", "H", "w"))
    emit("kernel", name="qr_panel_batched", dtype="complex", cases=rows)
    return out


# the order of the complex128 operators and of the complex64 CALU and
# no-pivot ones (the complex64 chol and lu operators take the main path's)
COMPLEX_SMALL_N = 4096


def launch_snapshot(ho):
    """The launch counts by kernel and by element type, copied."""
    return dict(ho.LAUNCHES), {k: dict(v) for k, v in
                               ho.TYPE_LAUNCHES.items()}


def complex_gels_check(torch, stt, ho, gen):
    """gels on the card in complex against a complex128 solve by the
    normal equations (the minimum-norm one for m < n): (1500, 1000) at
    nb = 32 in complex64 and complex128 (K3 in every panel), and the
    underdetermined (1000, 1500) complex64 at nb = 128 (gelqf: K4)."""
    out = {}
    for name, (m, n_), nb, dt in (
            ("gels_c64_nb32", (1500, 1000), 32, torch.complex64),
            ("gels_c128_nb32", (1500, 1000), 32, torch.complex128),
            ("gels_c64_wide", (1000, 1500), 128, torch.complex64)):
        a = torch.randn((m, n_), generator=gen, device="cuda", dtype=dt)
        b = torch.randn((m, 2), generator=gen, device="cuda", dtype=dt)
        before = dict(ho.LAUNCHES)
        X = stt.gels(stt.from_dense(a, nb, device="cuda"),
                     stt.from_dense(b, nb, device="cuda"))
        torch.cuda.synchronize()
        launches = {k: ho.LAUNCHES[k] - before[k]
                    for k in ("qr_panel_base", "qr_panel_base_wide")}
        x = X.dense()[:n_, :2]
        a64 = wide(torch, a)
        if m >= n_:
            ref = lstsq_normal64(torch, a64, b)
        else:
            ref = a64.mH @ torch.linalg.solve(a64 @ a64.mH, wide(torch, b))
        rel = max(rel_errors(torch, x, ref))
        check(x.shape == (n_, 2) and math.isfinite(rel) and rel <= 1e-3,
              f"{name}: relative error {rel} vs a complex128 solve")
        out[name] = {"m": m, "n": n_, "nb": nb, "dtype": dtype_name(dt),
                     "rel_err": rel, "launches": launches}
    for name in ("gels_c64_nb32", "gels_c128_nb32"):
        k3 = out[name]["launches"]["qr_panel_base"]
        check(k3 >= 32, f"{name} launched qr_panel_base {k3} < 32 times")
    check(out["gels_c64_wide"]["launches"]["qr_panel_base_wide"] > 0,
          "the complex LQ gels did not launch qr_panel_base_wide")
    return out


def complex_phase(torch, stt, ho, n, nb, gen):
    """A Session serving complex operators through the LU, Cholesky and
    QR paths: Hermitian positive definite (chol) and general (lu)
    complex64 operators at the main path's n and nb, a tall complex64
    (2n × n/2) qr operator at the main path's qr shape, the chol and lu
    ones in complex128 at COMPLEX_SMALL_N and a complex128 qr one at
    (2·COMPLEX_SMALL_N, COMPLEX_SMALL_N/2), general ones there in
    complex64 and complex128 with MethodLU.CALU, and a diagonally
    dominant complex64 one with MethodLU.NoPiv; each factored once and
    serving 8 requests of 1 and 16 columns. Every served column's scaled
    residual ≤ 30 in complex128 (qr: within QR_REL_LIMIT of a complex128
    solve, as the main path's qr); potri and getri of the complex128
    factors held to ‖I − A·X‖₁ / (n·ε·‖A‖₁·‖X‖₁) ≤ 30;
    torch.linalg.cholesky, lu_factor and torch.geqrf on the complex64
    operators timed beside the factors; complex gels at nb = 32 (K3) and
    by LQ (complex_gels_check). The factors launch the complex instances
    of K1 (chol), K2 (lu), K3/K4 (qr), P3 and P2 (CALU), P2 (NoPiv) and
    P1, and no K5 or P5."""
    from slate_tpu_torch.obs import flops
    from slate_tpu_torch.runtime.metrics import Histogram
    dev = "cuda"
    c64, c128 = torch.complex64, torch.complex128
    n2 = min(n, COMPLEX_SMALL_N)

    def hpd(m, dt):
        x = torch.randn((m, m), generator=gen, device=dev, dtype=dt)
        a = x @ x.mH / m
        a.diagonal().add_(1.0)
        return a

    def general(m, dt, cols=None):
        return torch.randn((m, cols or m), generator=gen, device=dev,
                           dtype=dt)

    lu_opts = {"calu": stt.Options(method_lu=stt.MethodLU.CALU),
               "nopiv": stt.Options(method_lu=stt.MethodLU.NoPiv)}
    # name: (operator, op, options)
    operators = {"chol_c64": (hpd(n, c64), "chol", None),
                 "lu_c64": (general(n, c64), "lu", None),
                 "qr_c64": (general(2 * n, c64, n // 2), "qr", None),
                 "chol_c128": (hpd(n2, c128), "chol", None),
                 "lu_c128": (general(n2, c128), "lu", None),
                 "qr_c128": (general(2 * n2, c128, n2 // 2), "qr", None),
                 "lu_calu_c64": (general(n2, c64), "lu", lu_opts["calu"]),
                 "lu_calu_c128": (general(n2, c128), "lu", lu_opts["calu"]),
                 "nopiv_c64": (dominant(torch, n2, gen, c64), "lu",
                               lu_opts["nopiv"])}
    widths = (1, 16, 1, 16, 1, 16, 1, 16)
    rhs = {name: [torch.randn((a.shape[0], k), generator=gen, device=dev,
                              dtype=a.dtype) for k in widths]
           for name, (a, _, _) in operators.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sess = stt.Session(hbm_budget=16 << 30, device=dev)
    handles = {}
    for name, (a, op, opts) in operators.items():
        A = (stt.hermitian(a, nb, stt.Uplo.Lower, device=dev) if op == "chol"
             else stt.from_dense(a, nb, device=dev))
        handles[name] = sess.register(A, op=op, opts=opts)
    factor_s, info, factor_launches = {}, {}, {}
    for name, h in handles.items():
        before = dict(ho.LAUNCHES)
        t0 = time.perf_counter()
        info[name] = sess.factor_info(h)
        torch.cuda.synchronize()
        factor_s[name] = time.perf_counter() - t0
        factor_launches[name] = {k: ho.LAUNCHES[k] - before[k]
                                 for k in ho.LAUNCHES}
    latency = {name: Histogram() for name in handles}
    served = {name: [] for name in handles}
    for name, h in handles.items():
        for b in rhs[name]:
            t0 = time.perf_counter()
            xs = torch.from_numpy(sess.solve(h, b)).to(dev)
            latency[name].observe(time.perf_counter() - t0)
            served[name].append(xs)
    peak = torch.cuda.max_memory_allocated()
    inverse = {}
    for name, key, fn in (("potri", "chol_c128",
                           stt.chol_inverse_using_factor),
                          ("getri", "lu_c128", stt.lu_inverse_using_factor)):
        before = dict(ho.LAUNCHES)
        t0 = time.perf_counter()
        X = fn(*sess.factor(handles[key]).payload)
        torch.cuda.synchronize()
        inverse[name] = {"operator": key,
                         "seconds": time.perf_counter() - t0,
                         "launches": {k: ho.LAUNCHES[k] - before[k]
                                      for k in ho.LAUNCHES
                                      if ho.LAUNCHES[k] != before[k]}}
        r = inverse_residual(torch, operators[key][0], X.dense()[:n2, :n2])
        inverse[name]["inverse_residual"] = r
        check(math.isfinite(r) and r <= RESIDUAL_BOUND,
              f"complex {name}: ‖I − A·X‖₁ / (n·ε·‖A‖₁·‖X‖₁) = {r}")
        del X
    # the library yardsticks on the complex64 operators (a warm call first)
    library = {}
    for name, key, fn in (("cholesky", "chol_c64", torch.linalg.cholesky),
                          ("lu_factor", "lu_c64", torch.linalg.lu_factor),
                          ("geqrf", "qr_c64", torch.geqrf)):
        a = operators[key][0]
        fn(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(a)
        torch.cuda.synchronize()
        library[f"{name}_s"] = time.perf_counter() - t0
        del out
    res = {name: [] for name in handles if not name.startswith("qr")}
    qr_rel = {}
    for name, (a, op, _) in operators.items():
        if op == "qr":  # every served column against a complex128 solve
            b_all = torch.cat(rhs[name], dim=1)
            x_all = torch.cat(served[name], dim=1)
            check(x_all.shape == (a.shape[1], b_all.shape[1]),
                  f"complex {name}: solve shape {tuple(x_all.shape)}")
            qr_rel[name] = max(rel_errors(torch, x_all, lstsq_normal64(
                torch, wide(torch, a), b_all)))
            continue
        for xs, b in zip(served[name], rhs[name]):
            res[name] += scaled_residuals(torch, a, xs, b, in_wide=True)
    check(all(math.isfinite(v) and v <= QR_REL_LIMIT
              for v in qr_rel.values()),
          f"complex qr solves: relative error {qr_rel} vs complex128 > "
          f"{QR_REL_LIMIT}")
    gels = complex_gels_check(torch, stt, ho, gen)
    check(all(v == 0 for v in info.values()), f"complex factor info {info}")
    worst = max(max(v) for v in res.values())
    check(math.isfinite(worst) and worst <= RESIDUAL_BOUND,
          f"complex scaled residual {worst} > {RESIDUAL_BOUND}: "
          f"{ {k: max(v) for k, v in res.items()} }")
    fl = factor_launches
    nt = -(-n // nb)
    check(fl["chol_c64"]["chol_tile"] >= nt,
          f"complex chol launched chol_tile {fl['chol_c64']['chol_tile']} "
          f"< {nt} times")
    k2 = fl["lu_c64"]["lu_panel_base"]
    check(k2 == 4 * nt if nb == 512 else k2 >= nt,
          f"complex lu launched lu_panel_base {k2} times for {nt} panels")
    check(fl["chol_c128"]["chol_tile"] > 0
          and fl["lu_c128"]["lu_panel_base"] > 0,
          f"complex128 factors launched {fl['chol_c128']}, {fl['lu_c128']}")
    kt = -(-(n // 2) // nb)
    k3, k4 = fl["qr_c64"]["qr_panel_base"], fl["qr_c64"]["qr_panel_base_wide"]
    check(k4 == 4 * kt and k3 == 0 if nb == 512 else k3 + k4 >= kt,
          f"the complex64 qr factor launched {fl['qr_c64']} for {kt} panels")
    check(fl["qr_c128"]["qr_panel_base_wide"] > 0,
          f"the complex128 qr factor launched {fl['qr_c128']}")
    for name in ("lu_calu_c64", "lu_calu_c128"):
        calu = fl[name]
        check(calu["lu_panel_batched"] > 0 and calu["lu_nopiv_base"] > 0
              and calu["lu_panel_base"] == 0,
              f"the complex CALU factor {name} launched {calu}")
    nopiv = fl["nopiv_c64"]
    check(nopiv["lu_nopiv_base"] > 0 and nopiv["lu_panel_base"] == 0
          and nopiv["lu_panel_batched"] == 0,
          f"the complex no-pivot factor launched {nopiv}")
    launches, type_launches = launch_snapshot(ho)
    check(not launches["herk_lower_update"],
          f"the complex phase launched the real-only K5: {launches}")
    check(not launches["qr_panel_batched"],
          f"the complex phase launched the batched engine's P5: {launches}")
    for k in ("chol_tile", "lu_panel_base", "lu_nopiv_base",
              "lu_panel_batched", "trtri_leaves", "qr_panel_base",
              "qr_panel_base_wide"):
        check(set(type_launches[k]) <= {"complex64", "complex128"}
              and type_launches[k], f"{k} launched {type_launches[k]}")
    per = {name: {"p50": h.percentile(50), "p99": h.percentile(99)}
           for name, h in latency.items()}
    solve_hist = sess.metrics.histogram("solve_latency")
    four = {"chol": 4 * flops.potrf(n), "lu": 4 * flops.getrf(n),
            "qr": 4 * flops.geqrf(2 * n, n // 2)}
    return {
        "n": n, "nb": nb, "n_small": n2, "requests_per_operator": len(widths),
        "operators": {name: {"n": a.shape[0], "dtype": dtype_name(a.dtype),
                             "op": op, "method": (opts.method_lu.name
                                                  if opts else "default")}
                      for name, (a, op, opts) in operators.items()},
        "factor_s": factor_s,
        # LAWN 41's complex counts in real operations: potrf 4n³/3,
        # getrf 8n³/3
        "chol_c64_gflops": four["chol"] / factor_s["chol_c64"] / 1e9,
        "lu_c64_gflops": four["lu"] / factor_s["lu_c64"] / 1e9,
        # geqrf: 4·(2mn² − 2n³/3) real operations
        "qr_c64_shape": [2 * n, n // 2],
        "qr_c64_gflops": four["qr"] / factor_s["qr_c64"] / 1e9,
        "library": {**library,
                    "cholesky_gflops": four["chol"] / library["cholesky_s"]
                    / 1e9,
                    "lu_factor_gflops": four["lu"] / library["lu_factor_s"]
                    / 1e9,
                    "geqrf_gflops": four["qr"] / library["geqrf_s"] / 1e9},
        "qr_rel_err_max": qr_rel, "qr_rel_err_limit": QR_REL_LIMIT,
        "gels": gels,
        "solve_latency_s": per,
        "solve_p50_s": solve_hist["p50"], "solve_p99_s": solve_hist["p99"],
        "solves": solve_hist["count"],
        "max_memory_allocated": peak,
        "inverse": inverse,
        "scaled_residual_max": {k: max(v) for k, v in res.items()},
        "residuals_checked": {k: len(v) for k, v in res.items()},
        "gate": RESIDUAL_BOUND,
        "launches_factor": {k: {kk: vv for kk, vv in v.items() if vv}
                            for k, v in factor_launches.items()},
        "launches": launches, "launches_by_dtype": type_launches,
    }


# ---------------------------------------------------------------------------
# the mixed-precision slice: bf16 kernel rows and the mixed phase

# NVIDIA H100 SXM data sheet (dense, 700 W): BF16 tensor cores 989 TFLOP/s
BF16_PEAK_FLOPS = 989e12
# K5 bf16 against its plain version, entry by entry on the lower triangle:
# both round the float32 k-long product to bfloat16 and subtract in
# bfloat16, so where their float32 sums (apart by at most
# 2k·2⁻²⁴·(|A|·|A|ᵀ)ᵢⱼ) straddle a rounding boundary the rounded product
# moves one unit of |A·Aᵀ| and the difference rounds once more on the
# result's grid: two bfloat16 units in the last place of |C| + |A·Aᵀ|
HERK_BF16_ULPS = 2
MIXED_WIDTHS = (1, 16, 1, 16, 1, 16, 1, 16)
MIXED_COMPLEX_N = 4096
MIXED_SMALL_RUNS = ((256, 1000), (32, 10000))
MIXED_SMALL_OPS = 1000
MIXED_BITS_SAMPLE = 2  # replayed refined solves compared with eager drive


def ulp_bf16(torch, v):
    """One bfloat16 unit in the last place of |v| (8 significant bits)."""
    v = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def herk_bf16_case(torch, ho, n, k, gen, timed=False, strided=False,
                   nan_row=None):
    """K5's bfloat16 instance against its plain version (the TPU
    kernel's rounding: the float32 product rounded to bfloat16, then
    subtracted in bfloat16) entry by entry within HERK_BF16_ULPS units of
    |C| + |A·Aᵀ| plus 2k·2⁻²⁴·(|A|·|A|ᵀ); the strict upper triangle of C
    bitwise unchanged; its plan the C launcher's. ``strided``: C and A
    are views of one (n + k)² tensor whose row stride is not 16-byte
    aligned when k is odd (A staged one element at a time).
    ``nan_row``: a NaN in that row of A poisons that row and column of
    the lower result in both, and nothing else."""
    bf = torch.bfloat16
    if strided:
        big = torch.randn((n + k, n + k), generator=gen, device="cuda").to(bf)
        bk, bp = big.clone(), big.clone()
        ck, ak, cp, ap = bk[k:, k:], bk[k:, :k], bp[k:, k:], bp[k:, :k]
    else:
        c = torch.randn((n, n), generator=gen, device="cuda").to(bf)
        ak = ap = torch.randn((n, k), generator=gen, device="cuda").to(bf)
        if nan_row is not None:
            ak = ap = ak.clone()
            ak[nan_row, k // 2] = math.nan
        ck, cp = c.clone(), c.clone()
    c0 = ck.clone()
    plan = herk_plan_row(ho, ck)
    ho.herk_lower_update(ck, ak)
    ho.herk_lower_update_plain(cp, ap, tile=plan["tile"])
    torch.cuda.synchronize()
    low = torch.ones((n, n), dtype=torch.bool, device="cuda").tril()
    a64, c64 = ak.double(), c0.double()
    prod = a64 @ a64.mT
    tol = (HERK_BF16_ULPS * ulp_bf16(torch, c64.abs() + prod.abs())
           + 2 * k * 2.0 ** -24 * (a64.abs() @ a64.abs().mT))
    diff = (ck.double() - cp.double()).abs()
    name = f"herk_lower_update bf16 {(n, k)}"
    if nan_row is not None:
        bad = torch.zeros_like(low)
        bad[nan_row, :] = bad[:, nan_row] = True
        check(torch.equal(torch.isnan(ck) & low, bad & low)
              and torch.equal(torch.isnan(cp) & low, bad & low),
              f"{name}: the NaN row poisoned other entries")
        keep = low & ~bad
    else:
        keep = low
    ratio = (diff / tol)[keep].max().item()
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: |kernel - plain| {ratio}× the tolerance")
    check(torch.equal(ck[~low], c0[~low]), f"{name}: strict upper changed")
    if strided:
        keep_big = torch.ones_like(bk, dtype=torch.bool)
        keep_big[k:, k:] = ~low
        check(torch.equal(bk[keep_big], big[keep_big]),
              f"{name}: wrote outside the lower triangle of the view")
    row = {"n": n, "k": k, "dtype": "bfloat16", "strided": strided,
           "nan_row": nan_row, "plan": plan,
           "max_abs_err": diff[keep].max().item(), "tol_ratio_max": ratio,
           "entries_differing": int((ck != cp)[keep].sum().item()),
           "upper_unchanged": True}
    if timed:
        work = c0.clone()
        row["ms"] = cuda_ms(lambda: ho.herk_lower_update(work, ak))
        row["device_ms"] = device_ms(lambda: ho.herk_lower_update(work, ak))
        row["plain_ms"] = cuda_ms(
            lambda: ho.herk_lower_update_plain(work, ak, tile=plan["tile"]),
            reps=5)
        row["library_ms"] = cuda_ms(
            lambda: torch.addmm(c0, ak, ak.mT, alpha=-1))
        nbytes, flops = n * (n + 1) * 2 + n * k * 2, float(n) * (n + 1) * k
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / BF16_PEAK_FLOPS * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["tflops"] = flops / row["ms"] / 1e9
    return row


def bf16_route_case(torch, ho, name, launcher, plain, x, f32_tol=None,
                    timed=True):
    """One kernel's bf16 route (its float32 instance on a float32 copy,
    rounded back) against its plain version's route on the same input.
    K2, P3 and P4 are bitwise their plain versions in float32, so their
    routes must be too (``f32_tol`` None); K1 and P1 differ from theirs
    by the order of their sums, within ``f32_tol(want, x)`` entry by
    entry in float32 (their own tolerances), so theirs may differ by that
    plus one bfloat16 unit where the two float32 results straddle a
    rounding boundary. Timed: the route beside the float32 instance on
    the upcast (the copies' cost)."""
    got = launcher(x)
    want = plain(x)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(got[0].dtype == torch.bfloat16, f"{name} bf16: {got[0].dtype} out")
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    w64 = want[0].double()
    d = (got[0].double() - w64).abs()
    fin = torch.isfinite(want[0])
    ratio = None
    if f32_tol is None:
        check(bitwise, f"{name} bf16 route: not bitwise its plain version")
    else:
        tol = ulp_bf16(torch, w64) + f32_tol(w64, x.double())
        ratio = (d / tol)[fin].max().item()
        check(ratio <= 1.0 and torch.equal(fin, torch.isfinite(got[0])),
              f"{name} bf16 route: {ratio}× its tolerance from its plain "
              "version")
    row = {"name": name, "shape": list(x.shape), "dtype": "bfloat16",
           "route": "float32 instance on a float32 copy",
           "bitwise": bitwise, "tol_ratio_max": ratio,
           "max_abs_err": d[fin].max().item()}
    if timed:
        x32 = x.float()
        row["ms"] = cuda_ms(lambda: launcher(x))
        row["f32_instance_ms"] = cuda_ms(lambda: launcher(x32))
        row["copy_ms"] = row["ms"] - row["f32_instance_ms"]
        row["plain_ms"] = cuda_ms(lambda: plain(x), reps=3)
        # the copies move 2 + 4 bytes in and 4 + 2 out per entry
        row["copy_bound_ms"] = 12 * x.numel() / PEAK_BYTES_PER_S * 1e3
    return row


def bf16_kernel_rows(torch, ho, gen, n, nb):
    """The kernel phase's bfloat16 rows: K5's instance at the shapes the
    mixed phase's nb = 128 bf16 potrf gives it (its recursion's trailing
    updates, (n/2)², (n/4)² and (n/8)² at k = the same, the widest timed),
    at 8192² × 1024 and 2048² × 512 (timed), strided views whose row
    stride is and is not 16-byte aligned (A staged 16 bytes or one
    element at a time) and a NaN row; the bf16 routes of K1, K2, P1, P3
    and P4 at the main path's and the engine's shapes."""
    bf = torch.bfloat16
    rec = [(n // d, n // d) for d in (2, 4, 8)]
    k5 = [herk_bf16_case(torch, ho, hn, hk, gen, timed=i == 0)
          for i, (hn, hk) in enumerate(rec)]
    k5 += [herk_bf16_case(torch, ho, hn, hk, gen, timed=True)
           for hn, hk in ((min(8192, n // 2), 1024), (2048, 512))
           if (hn, hk) not in rec]
    k5 += [herk_bf16_case(torch, ho, 1000, 301, gen, strided=True),
           herk_bf16_case(torch, ho, 2000, 704, gen, strided=True),
           herk_bf16_case(torch, ho, 512, 128, gen, nan_row=37)]
    spd = spd_tile(torch, nb, torch.float32, gen).to(bf)
    leaves = torch.tril(torch.randn((256, 64, 64), generator=gen,
                                    device="cuda"))
    leaves.diagonal(dim1=1, dim2=2).add_(8.0)
    p4 = torch.randn((1000, 32, 32), generator=gen, device="cuda")
    p4 = p4 @ p4.mT / 32
    p4.diagonal(dim1=1, dim2=2).add_(1.0)
    eps32 = torch.finfo(torch.float32).eps

    def k1_tol(w, _):  # chol_case's float32 tolerance
        return 1e-5 * w.abs().max()

    def p1_tol(w, leaf):  # LEAF_ENTRY_C·s·ε·(|X|·|L|·|X|), as trtri_case
        s_ = leaf.shape[-1]
        return ho.LEAF_ENTRY_C * s_ * eps32 * (
            w.abs() @ torch.tril(leaf).abs() @ w.abs())

    routes = [
        bf16_route_case(torch, ho, "chol_tile", ho.chol_tile,
                        ho.chol_tile_plain, spd, k1_tol),
        bf16_route_case(torch, ho, "lu_panel_base", ho.lu_panel_base,
                        ho.lu_panel_base_plain,
                        torch.randn((n, 128), generator=gen,
                                    device="cuda").to(bf)),
        bf16_route_case(torch, ho, "trtri_leaves", ho.trtri_leaves,
                        ho.trtri_leaves_plain, leaves.to(bf), p1_tol),
        bf16_route_case(torch, ho, "lu_panel_batched", ho.lu_panel_batched,
                        ho.lu_panel_batched_plain,
                        torch.randn((1000, 256, 32), generator=gen,
                                    device="cuda").to(bf)),
        bf16_route_case(torch, ho, "chol_tile_batched", ho.chol_tile_batched,
                        ho.chol_tile_batched_plain, p4.to(bf))]
    return k5, routes


def _request_stream(torch, gen, n, dtype, count):
    return [torch.randn((n, MIXED_WIDTHS[i % len(MIXED_WIDTHS)]),
                        generator=gen, device="cuda", dtype=dtype)
            for i in range(count)]


def mixed_operand(torch, kind, n, dtype, gen):
    """spd: X·Xᴴ/n + I; dom: X/√n + 2I; gauss: X (κ about 10⁴·n)."""
    x = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype)
    if kind == "spd":
        a = x @ x.mH / n
        a.diagonal().add_(1.0)
        return a
    if kind == "dom":
        x /= math.sqrt(n)
        x.diagonal().add_(2.0)
    return x


def mixed_serve_operator(torch, stt, ho, sess, ex, name, a, op, nb, policy,
                         gen):
    """One refined operator: its low-precision factor (wall, resident
    bytes, launches by type) beside the unrefined working-precision
    factor of the same operator, Executor.warmup (wall, aot_compiles,
    graph bytes), 8 requests (vectors and 16-column blocks) one at a
    time with their iterations and latency, every served column under the
    gate, and the replayed refined solves against the eager drive on the
    same resident, bit for bit."""
    from slate_tpu_torch.refine import engine
    from slate_tpu_torch.runtime.metrics import Histogram
    dev = "cuda"
    A = (stt.hermitian(a, nb, stt.Uplo.Lower, device=dev) if op == "chol"
         else stt.from_dense(a, nb, device=dev))
    m = sess.metrics
    # the unrefined factor of the same operator, for its wall and bytes
    plain = stt.Session(device=dev)
    hp = plain.register(A, op=op)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.factor(hp)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_bytes = plain.cached_bytes
    plain.close()
    del plain
    h = sess.register(A, op=op, refine=policy)
    snap0 = launch_snapshot(ho)
    t0 = time.perf_counter()
    res = sess.factor(h)
    torch.cuda.synchronize()
    factor_wall = time.perf_counter() - t0
    snap1 = launch_snapshot(ho)
    check(res.info == 0 and sess.degrade_class(h) == "mixed",
          f"mixed {name}: low-precision factor info {res.info}")
    lo = str(res.payload[0].dtype).split(".")[1]
    check(lo == policy.factor_dtype, f"mixed {name}: resident is {lo}")
    resident = res.nbytes
    compiles = m.get("aot_compiles")
    t0 = time.perf_counter()
    ex.warmup([h])
    warm_wall = time.perf_counter() - t0
    graph_bytes = sum(g.nbytes for g in res.graphs.values())
    captured = m.get("aot_compiles") - compiles
    graphs = policy.strategy == "ir"
    check(captured == (2 if graphs else 0),
          f"mixed {name}: warmup captured {captured}")
    n = a.shape[0]
    lat, iters, worst = Histogram(), [], 0.0
    fallbacks = m.get("refine_fallbacks_total")
    for b in _request_stream(torch, gen, n, a.dtype, 8):
        h0 = m.histogram("refine_iterations")
        t0 = time.perf_counter()
        x = ex.submit(h, b.cpu().numpy()).result(timeout=RESULT_TIMEOUT)
        lat.observe(time.perf_counter() - t0)
        h1 = m.histogram("refine_iterations")
        iters.append(h1["sum"] - h0["sum"])
        xt = torch.from_numpy(x).to(dev)
        xt = xt[:, None] if xt.ndim == 1 else xt
        worst = max(worst, max(scaled_residuals(torch, a, xt, b, True)))
    check(m.get("refine_fallbacks_total") == fallbacks,
          f"mixed {name}: a served solve fell back")
    check(math.isfinite(worst) and worst <= RESIDUAL_BOUND,
          f"mixed {name}: worst scaled residual {worst}")
    row = {"op": op, "n": n, "nb": nb, "dtype": dtype_name(a.dtype),
           "factor_dtype": lo, "strategy": policy.strategy,
           "factor_wall_s": factor_wall,
           "working_factor_wall_s": plain_wall,
           "resident_bytes": resident,
           "working_resident_bytes": plain_bytes,
           "bytes_ratio": resident / plain_bytes,
           "factor_launches_by_dtype": {
               k: {t: c - snap0[1][k].get(t, 0) for t, c in v.items()
                   if c != snap0[1][k].get(t, 0)}
               for k, v in snap1[1].items() if v != snap0[1][k]},
           "warmup_wall_s": warm_wall, "aot_compiles": captured,
           "graph_bytes": graph_bytes, "requests": len(iters),
           "iterations": iters, "worst_scaled_residual": worst,
           "gate": RESIDUAL_BOUND, "request_p50_s": lat.percentile(50),
           "request_p99_s": lat.percentile(99)}
    if graphs:
        # replayed (solve_matrix on the warmed resident) against the eager
        # drive of the engine's own start and step on the same resident
        entry = sess._ops[h]
        res = sess.factor(h)
        same = []
        for b in _request_stream(torch, gen, n, a.dtype,
                                 MIXED_BITS_SAMPLE):
            B = stt.from_dense(b, nb, device=dev)
            Xr = sess.solve_matrix(h, B)
            Xe, _, conv = engine.drive(
                engine.make_start_fn(op, entry.opts, policy, a.dtype),
                engine.make_step_fn(op, entry.opts, policy, a.dtype),
                res.payload, entry.A, B, entry.anorm, policy, a.dtype)
            same.append(bool(conv) and torch.equal(Xr.data, Xe.data))
        check(all(same), f"mixed {name}: replayed solves differ from the "
              f"eager drive ({same})")
        row["replay_equals_eager_bitwise"] = same
    return h, row


def mixed_batched_run(torch, stt, ho, verb, n, bsz, work, gen):
    """gesv/posv_mixed_batched at (n, B), 2 right-hand sides: a warm call,
    then one timed (wall, requests per second, launches by type), every
    item under the gate, the iteration histogram, and the plain batched
    verb in the working precision timed beside it."""
    lo = {torch.float32: "bfloat16", torch.float64: "float32"}[work]
    a = mixed_operand_stack(torch, verb, bsz, n, work, gen)
    b = torch.randn((bsz, n, SMALL_RHS), generator=gen, device="cuda",
                    dtype=work)
    fn = getattr(stt, f"{verb}_mixed_batched")
    fn(a, b, factor_dtype=lo)
    before = launch_snapshot(ho)[1]
    (x, info, iters), wall, launches = launches_of(
        ho, lambda: fn(a, b, factor_dtype=lo))
    after = launch_snapshot(ho)[1]
    name = f"mixed {verb}_batched (n={n}, B={bsz}, {dtype_name(work)})"
    check(not info.any(), f"{name}: info on {int(info.count_nonzero())}")
    gate = batched_residuals(torch, a, x, b)
    worst = gate.max().item()
    check(math.isfinite(worst) and worst <= RESIDUAL_BOUND,
          f"{name}: worst item {worst}")
    plain = getattr(stt, f"{verb}_batched")
    plain(a, b)
    _, plain_wall, _ = launches_of(ho, lambda: plain(a, b))
    vals, counts = torch.unique(iters, return_counts=True)
    return {"verb": verb, "n": n, "B": bsz, "k": SMALL_RHS,
            "dtype": dtype_name(work), "factor_dtype": lo, "wall_s": wall,
            "req_per_s": bsz / wall, "launches": launches,
            "launches_by_dtype": {k: {t: c - before[k].get(t, 0)
                                      for t, c in v.items()
                                      if c != before[k].get(t, 0)}
                                  for k, v in after.items()
                                  if v != before[k]},
            "worst_scaled_residual": worst, "gate": RESIDUAL_BOUND,
            "iterations": dict(zip(vals.tolist(), counts.tolist())),
            "fallback_items": int((iters < 0).sum().item()),
            "plain_wall_s": plain_wall, "plain_req_per_s": bsz / plain_wall}


def mixed_operand_stack(torch, verb, bsz, n, dtype, gen):
    a = torch.randn((bsz, n, n), generator=gen, device="cuda", dtype=dtype)
    if verb == "posv":
        a = a @ a.mT / n
    else:
        a /= math.sqrt(n)
        a.diagonal(dim1=1, dim2=2).add_(1.0)
    a.diagonal(dim1=1, dim2=2).add_(1.0)
    return a


def mixed_small_session(torch, stt, gen):
    """MIXED_SMALL_OPS refined lu_small operators at n = 256 (f32 ← bf16)
    grouped through solve_small_batched: every factor a miss, then every
    factor resident; counters, the gate, and grouped against per-request
    bits (printed, not required)."""
    n = 256
    mats = mixed_operand_stack(torch, "gesv", MIXED_SMALL_OPS, n,
                               torch.float32, gen)
    rhs = torch.randn((MIXED_SMALL_OPS, n), generator=gen, device="cuda")
    sess = stt.Session(device="cuda")
    hs = [sess.register(mats[i], op="lu_small", refine=True)
          for i in range(MIXED_SMALL_OPS)]
    bs = [rhs[i] for i in range(MIXED_SMALL_OPS)]
    out = {"ops": MIXED_SMALL_OPS, "n": n, "dtype": "float32",
           "factor_dtype": "bfloat16"}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, infos = sess.solve_small_batched(hs, bs)
        wall = time.perf_counter() - t0
        check(not any(infos), f"mixed small {label}: infos")
        x = torch.from_numpy(xs).to("cuda")[:, :, None]
        worst = batched_residuals(torch, mats, x, rhs[:, :, None]).max()
        check(worst.item() <= RESIDUAL_BOUND,
              f"mixed small {label}: worst {worst.item()}")
        out[label] = {"wall_s": wall, "req_per_s": MIXED_SMALL_OPS / wall,
                      "worst_scaled_residual": worst.item()}
    per = [sess.solve(hs[i], bs[i]) for i in range(8)]
    out["grouped_equals_per_request_bitwise"] = [
        bool((per[i] == xs[i]).all()) for i in range(8)]
    m = sess.metrics
    out["counters"] = {k: m.get(k) for k in (
        "cache_hits", "cache_misses", "factors_total", "batched_programs",
        "refine_converged_total", "refine_fallbacks_total")}
    out["resident_bytes"] = sess.cached_bytes
    check(out["counters"]["refine_fallbacks_total"] == 0,
          "mixed small: a refined item fell back")
    return out


def mixed_phase(torch, stt, ho, n, nb, gen):
    """The mixed phase (see the module docstring)."""
    from slate_tpu_torch.runtime import FaultPlan, FaultSpec
    dev = "cuda"
    f32, f64 = torch.float32, torch.float64
    c128 = torch.complex128
    P = stt.RefinePolicy
    spd32 = mixed_operand(torch, "spd", n, f32, gen)
    out = {"n": n, "nb": nb, "operators": {}}
    sess = stt.Session(device=dev)
    m = sess.metrics
    handles = {}
    with stt.Executor(sess, max_batch=32, max_wait=1e-3) as ex:
        nb_rec = n // 128
        plan = [("chol_f32_bf16", spd32, "chol", nb, P("bfloat16")),
                ("lu_f32_bf16", mixed_operand(torch, "dom", n, f32, gen),
                 "lu", nb, P("bfloat16")),
                ("chol_f64_f32", mixed_operand(torch, "spd", n, f64, gen),
                 "chol", nb, P("float32")),
                ("lu_f64_f32", mixed_operand(torch, "gauss", n, f64, gen),
                 "lu", nb, P("float32")),
                ("chol_f32_bf16_nb128", spd32, "chol", nb_rec,
                 P("bfloat16"))]
        nc = min(n, MIXED_COMPLEX_N)
        plan += [("chol_c128_c64", mixed_operand(torch, "spd", nc, c128,
                                                 gen), "chol", nb,
                  P("complex64")),
                 ("lu_c128_c64", mixed_operand(torch, "gauss", nc, c128,
                                               gen), "lu", nb,
                  P("complex64"))]
        operands = {}
        for name, a, op, opnb, pol in plan:
            h, row = mixed_serve_operator(torch, stt, ho, sess, ex, name, a,
                                          op, opnb, pol, gen)
            handles[name] = h
            operands[name] = a
            out["operators"][name] = row
        # the recursion's K5 launches in bfloat16: as many as the float32
        # nb = n/128 factor makes
        rec = out["operators"]["chol_f32_bf16_nb128"][
            "factor_launches_by_dtype"]
        k5 = rec.get("herk_lower_update", {}).get("bfloat16", 0)
        want = REC_POTRF_LAUNCHES.get(n, (None,))[0]
        check(k5 > 0 and (want is None or k5 == want),
              f"mixed: the bf16 nb = n/128 potrf made {k5} bf16 K5 "
              f"launches, expected {want}")
        out["k5_bf16_launches_nb128"] = k5
        # each operator's condition number κ₁ = ‖A‖₁·‖A⁻¹‖₁, the inverse
        # by torch.linalg in float64 (complex128): a yardstick only
        kappa = {}
        for name, a in operands.items():
            if a.data_ptr() not in kappa:
                w = wide(torch, a)
                inv = torch.linalg.inv(w)
                kappa[a.data_ptr()] = (w.abs().sum(0).max()
                                       * inv.abs().sum(0).max()).item()
                del w, inv
            out["operators"][name]["kappa1"] = kappa[a.data_ptr()]
        del operands
        # bf16 IR does not converge on a Gaussian f32 operator: the
        # counted fallback; then the same operator under GMRES-IR
        gauss = mixed_operand(torch, "gauss", n, f32, gen)
        b = torch.randn((n, 1), generator=gen, device=dev)
        drill = {}
        for label, pol in (("ir", P("bfloat16")),
                           ("gmres", P("bfloat16", strategy="gmres"))):
            h = sess.register(stt.from_dense(gauss, nb, device=dev),
                              op="lu", refine=pol)
            sess.factor(h)
            f0 = m.get("refine_fallbacks_total")
            h0 = m.histogram("refine_iterations")
            t0 = time.perf_counter()
            x = ex.submit(h, b.cpu().numpy()).result(timeout=RESULT_TIMEOUT)
            wall = time.perf_counter() - t0
            fell = m.get("refine_fallbacks_total") - f0
            worst = max(scaled_residuals(
                torch, gauss, torch.from_numpy(x).to(dev), b, True))
            check(worst <= RESIDUAL_BOUND,
                  f"mixed gaussian {label}: residual {worst}")
            drill[label] = {
                "converged": fell == 0, "fallbacks": fell,
                "iterations": m.histogram("refine_iterations")["sum"]
                - h0["sum"], "wall_s": wall, "worst_scaled_residual": worst,
                "class_after": sess.degrade_class(h)}
        check(drill["ir"]["fallbacks"] == 1,
              "mixed: bf16 IR on the Gaussian f32 operator did not take "
              "the counted fallback")
        out["gaussian_f32_bf16"] = drill
        del gauss
    # the fault drill: refine_no_converge on a dense mixed operator, then a
    # breaker trip on a mixed bucket (the working_precision rung)
    h = handles["lu_f32_bf16"]
    a = sess._ops[h].A.data
    f0 = m.get("refine_fallbacks_total")
    sess.enable_faults(FaultPlan(seed=18, specs=(
        FaultSpec("refine_no_converge", rate=1.0, count=1),)))
    b = torch.randn((n, 1), generator=gen, device=dev)
    x = torch.from_numpy(sess.solve(h, b)).to(dev)
    worst = max(scaled_residuals(torch, a[:n, :n], x, b, True))
    check(m.get("refine_fallbacks_total") == f0 + 1
          and worst <= RESIDUAL_BOUND
          and sess.degrade_class(h) == "dense",
          f"mixed fault drill: fallback {m.get('refine_fallbacks_total') - f0}"
          f", residual {worst}")
    drill = {"refine_no_converge": {"fallbacks": 1,
                                    "worst_scaled_residual": worst}}
    h = handles["chol_f64_f32"]
    a = sess._ops[h].A.full_dense()[:n, :n]
    sess.enable_faults(FaultPlan(seed=18, specs=(
        FaultSpec("dispatch_error", rate=1.0, count=2),)))
    served, classes = [], []
    with stt.Executor(sess, max_batch=1, max_wait=1e-3, retries=0,
                      breaker_threshold=2, breaker_cooldown=60.0) as ex:
        for i in range(4):
            b = torch.randn((n, 1), generator=gen, device=dev, dtype=f64)
            f = ex.submit(h, b.cpu().numpy())
            err = f.exception(timeout=RESULT_TIMEOUT)
            served.append(err is None)
            if err is None:
                x = torch.from_numpy(f.result()).to(dev)
                worst = max(scaled_residuals(torch, a, x, b, True))
                check(worst <= RESIDUAL_BOUND,
                      f"mixed breaker drill: residual {worst}")
            classes.append(sess.degrade_class(h))
    check(served == [False, True, True, True]
          and m.get("refine_demotions_total") == 1
          and classes == ["mixed", "dense", "dense", "dense"],
          f"mixed breaker drill: served {served}, classes {classes}, "
          f"demotions {m.get('refine_demotions_total')}")
    drill["breaker"] = {"served": served, "classes": classes,
                        "refine_demotions_total":
                            m.get("refine_demotions_total"),
                        "breaker_trips_total": m.get("breaker_trips_total")}
    sess.faults = None
    out["fault_drill"] = drill
    out["counters"] = {k: m.get(k) for k in (
        "refine_converged_total", "refine_fallbacks_total",
        "refine_demotions_total", "refine_flops_total", "aot_compiles",
        "graph_replays", "cache_hits", "cache_misses")}
    out["refine_iterations"] = m.histogram("refine_iterations")
    sess.close()
    del sess, spd32
    torch.cuda.empty_cache()
    out["batched"] = [mixed_batched_run(torch, stt, ho, verb, sn, bsz, work,
                                        gen)
                      for sn, bsz in MIXED_SMALL_RUNS
                      for verb in ("gesv", "posv") for work in (f32, f64)]
    out["small_session"] = mixed_small_session(torch, stt, gen)
    return out


# ---------------------------------------------------------------------------
# P6–P8, the incremental-update kernels, and phase 9: update
# ---------------------------------------------------------------------------

# a kernel against its plain version: max |kernel − plain| / max |plain|
UPDATE_TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12,
              "complex128": 1e-12,
              # one bfloat16 ulp at the largest entry: the float32 results
              # within 1e-5, rounded apart
              "bfloat16": 2.0 ** -7}
# P8's chain bound: cycles of one dependent rounded add or multiply, by
# real type (tools/p67_ablation.py's clock64() chains on an H100 80GB
# HBM3 at 700 W: 4.055 and 8.024 for both), at the SM's top clock
# (nvidia-smi clocks.max.sm)
DEP_CYCLES = {"float32": 4.055, "float64": 8.024}
UPDATE_SMALL_OPS = 1000  # chol_small operators of the update phase
UPDATE_SMALL_N = 256
# the untimed P6 rows (k = 3 at bucket 4 up and down, the bf16 route at
# kb = 16): their plain versions took about 200 s at n = 16384
P6_UNTIMED_N = 4096
# P8's timed complex rows: the f32 row's served (n/2, 512) shape at half
# its rows (their plain versions took about 26 s each at 8192)
P8_COMPLEX_NPAD = 4096


def once_ms(torch, fn):
    """(result, ms) of one call of ``fn`` by CUDA events: for the plain
    versions at the main path's shapes, whose one call is the comparison
    itself and takes seconds."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def rel_diff(torch, got, want) -> float:
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale > 0 else 1.0)


def update_factor(torch, n, npad, dtype, gen, bsz=None):
    """A lower Cholesky factor of x·xᴴ/n + 2I, padded with zeros to npad
    rows and columns, or a (bsz, n, n) stack of them (factored in float64
    or complex128 on the card, then cast)."""
    wide_t = torch.complex128 if dtype.is_complex else torch.float64
    shape = (n, n) if bsz is None else (bsz, n, n)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=wide_t)
    a = x @ x.mH / n
    a.diagonal(dim1=-2, dim2=-1).add_(2.0)
    l = torch.linalg.cholesky(a).to(dtype).contiguous()
    if bsz is not None or npad == n:
        return l
    out = torch.zeros((npad, npad), dtype=dtype, device="cuda")
    out[:n, :n] = l
    return out


def update_vectors(torch, rows, n, kb, k, dtype, gen, scale, bsz=None):
    """(rows, kb) update vectors (a (bsz, rows, kb) stack), ``scale``
    times Gaussian in the first n rows and k columns, zero beyond."""
    shape = (rows, kb) if bsz is None else (bsz, rows, kb)
    w = torch.zeros(shape, dtype=dtype, device="cuda")
    draw = (scale * torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.float64)).to(dtype)
    w[..., :n, :k] = draw[..., :n, :k]
    return w


def p6_case(torch, ho, n, kb, dtype, gen, sign=1, scale=0.3, k=None,
            bsz=None, timed=False):
    """P6 against its plain version on the same factor and vectors: the
    factor within UPDATE_TOL (bitwise printed), info equal, finite (also
    after a failed downdate). Timed rows: the kernel by CUDA events
    (median of 7, repeated updates of one factor), the plain version's one
    call, torch.linalg.cholesky of A' (the refactor the update replaces)
    and the bound."""
    k = kb if k is None else k
    npad = n if bsz is not None else -(-n // 512) * 512
    l = update_factor(torch, n, npad, dtype, gen, bsz)
    rows = n if bsz is not None else npad
    w = update_vectors(torch, rows, n, kb, k, dtype, gen, scale, bsz)
    narg = None if bsz is not None else n
    lk = l.clone()
    ik = ho.chol_update_sweep(lk, w, sign, narg)
    # bfloat16 takes P6's float32 instance on a float32 copy, rounded
    # back: its plain version is the float32 one on that copy
    bf16 = dtype == torch.bfloat16
    lp, wp = (l.float(), w.float()) if bf16 else (l.clone(), w)
    ip, plain_ms = once_ms(torch, lambda: ho.chol_update_sweep_plain(
        lp, wp, sign, narg))
    if bf16:
        lp = lp.to(dtype)
    dt = dtype_name(dtype)
    name = f"chol_update_sweep n={n} kb={kb} B={bsz} {dt} sign={sign}"
    ik_l, ip_l = ik.reshape(-1).tolist(), ip.reshape(-1).tolist()
    check(ik_l == ip_l, f"{name}: info {ik_l[:8]} against the plain "
          f"version's {ip_l[:8]}")
    check(bool(torch.isfinite(lk).all()), f"{name}: non-finite factor")
    err = rel_diff(torch, lk, lp)
    check(err <= UPDATE_TOL[dt], f"{name}: {err} from the plain version")
    row = {"n": n, "kb": kb, "k": k, "B": bsz, "dtype": dt, "sign": sign,
           "info_max": max(ik_l), "max_abs_err": err,
           "bitwise_equal": same_bits(torch, lk, lp),
           "plan": ho.chol_update_plan_for(n, kb, dtype)._asdict(),
           "launches_per_call": 1}
    if timed:
        lt = l.clone()
        row["ms"] = cuda_ms(lambda: ho.chol_update_sweep(lt, w, 1, narg))
        row["device_ms"] = device_ms(
            lambda: ho.chol_update_sweep(lt, w, 1, narg), launches=5)
        row["plain_ms"] = plain_ms
        a2 = l @ l.mH + w @ w.mH
        if bsz is None:
            a2 = a2[:n, :n]
        row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(a2))
        del a2
        it = l.element_size()
        items = bsz or 1
        nbytes = items * (n * (n + 1) * it + n * kb * it + 4)
        flops = items * 2.0 * n * n * kb
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    return row


def p6_invariants(torch, ho, gen):
    """P6's exact contracts on the card: a zero W changes no bit (n = 2048
    and 16384-row stacks too), k = 3 gives the same bits at buckets 4 and
    8, and each lane of a (8, 256, 256) stack is bit for bit its B = 1
    run (one with a failed downdate among them)."""
    out = {}
    for dt in (torch.float32, torch.complex128):
        l = update_factor(torch, 2000, 2048, dt, gen)
        lz = l.clone()
        ho.chol_update_sweep(lz, torch.zeros((2048, 4), dtype=dt,
                                             device="cuda"), 1, 2000)
        w = update_vectors(torch, 2048, 2000, 8, 3, dt, gen, 0.3)
        l4, l8 = l.clone(), l.clone()
        ho.chol_update_sweep(l4, w[:, :4].contiguous(), 1, 2000)
        ho.chol_update_sweep(l8, w, 1, 2000)
        ls = update_factor(torch, 256, 256, dt, gen, bsz=8)
        ws = update_vectors(torch, 256, 256, 2, 2, dt, gen, 0.01, bsz=8)
        ws[3] *= 1000.0
        lb = ls.clone()
        ib = ho.chol_update_sweep(lb, ws, -1)
        lanes = True
        for i in range(8):
            l1 = ls[i:i + 1].clone()
            i1 = ho.chol_update_sweep(l1, ws[i:i + 1].contiguous(), -1)
            lanes &= same_bits(torch, l1[0], lb[i]) and int(i1[0]) == int(
                ib[i])
        name = dtype_name(dt)
        check(same_bits(torch, lz, l), f"chol_update_sweep {name}: a zero "
              "update changed bits")
        check(same_bits(torch, l4, l8), f"chol_update_sweep {name}: bucket "
              "4 and 8 differ")
        check(lanes and int(ib[3]) > 0 and int(ib.count_nonzero()) == 1,
              f"chol_update_sweep {name}: a lane differs from its B = 1 run "
              f"(info {ib.tolist()})")
        out[name] = {"zero_update_bitwise": True, "bucket_4_8_bitwise": True,
                     "lanes_bitwise_b1": True, "lane_info": ib.tolist()}
    return out


def qr_append_operands(torch, npad, n, P, p_live, dtype, gen):
    """An upper-triangular R (npad²: Gaussian above the diagonal, √(4n) on
    it, as the R of a 4n × n Gaussian) and P appended rows, p_live of them
    Gaussian in the first n columns, the rest zero."""
    r = torch.triu(torch.randn((npad, npad), generator=gen, device="cuda",
                               dtype=torch.float64))
    r.diagonal().fill_(math.sqrt(4 * n))
    u = torch.zeros((P, npad), dtype=torch.float64, device="cuda")
    u[:p_live, :n] = torch.randn((p_live, n), generator=gen, device="cuda",
                                 dtype=torch.float64)
    if dtype.is_complex:
        r = r + 1j * torch.triu(torch.randn(
            (npad, npad), generator=gen, device="cuda",
            dtype=torch.float64), 1)
        u = u + 1j * u.flip(0)
    return r.to(dtype), u.to(dtype)


def p7_case(torch, ho, npad, n, P, p_live, dtype, gen, timed=False):
    """P7 against its plain version: R, w and tau within UPDATE_TOL
    (bitwise printed). Timed rows add the kernel by CUDA events, the plain
    version's one call, torch.geqrf of [R; U] and the bound. Returns (row,
    (w, tau) of the kernel)."""
    r0, u = qr_append_operands(torch, npad, n, P, p_live, dtype, gen)
    rk, rp = r0.clone(), r0.clone()
    wk, tk = ho.qr_append_build(rk, u, n)
    (wp, tp), plain_ms = once_ms(torch, lambda: ho.qr_append_build_plain(
        rp, u, n))
    dt = dtype_name(dtype)
    name = f"qr_append_build npad={npad} n={n} P={P} {dt}"
    err = max(rel_diff(torch, a, b) for a, b in ((rk, rp), (wk, wp),
                                                  (tk, tp)))
    check(err <= UPDATE_TOL[dt] and bool(torch.isfinite(rk).all()),
          f"{name}: {err} from the plain version")
    row = {"npad": npad, "n": n, "P": P, "p_live": p_live, "dtype": dt,
           "max_abs_err": err, "launches_per_call": 1,
           "plan": {"ctas": -(-npad // ho.P7_COLS), "threads": ho.P7_COLS},
           "bitwise_equal": all(same_bits(torch, a, b) for a, b in (
               (rk, rp), (wk, wp), (tk, tp)))}
    if timed:
        rt = r0.clone()
        row["ms"] = cuda_ms(lambda: ho.qr_append_build(rt, u, n))
        row["device_ms"] = device_ms(lambda: ho.qr_append_build(rt, u, n),
                                     launches=5)
        row["plain_ms"] = plain_ms
        ru = torch.cat([r0, u])
        row["library_ms"] = cuda_ms(lambda: torch.geqrf(ru))
        it = r0.element_size()
        nbytes = (npad * (npad + 1) + 2 * P * npad + npad) * it
        flops = 3.0 * n * n * P
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    zr = r0.clone()
    ho.qr_append_build(zr, torch.zeros_like(u), n)
    check(same_bits(torch, zr, r0), f"{name}: zero appended rows changed R")
    row["zero_rows_bitwise"] = True
    return row, (wk, tk)


def max_sm_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0])


def p8_chain_bound(n, P, dt: str) -> float:
    """Least time (ms) of P8's n steps by their dependent chain: P + 4
    rounded operations a step in real types, P + 7 in complex ones (a
    product part by part is two deep), each DEP_CYCLES of its real type, at
    the SM's top clock."""
    real = {"complex64": "float32", "complex128": "float64"}.get(dt, dt)
    ops = P + (7 if dt.startswith("complex") else 4)
    return n * ops * DEP_CYCLES[real] / (max_sm_mhz() * 1e3)


def p8_case(torch, ho, npad, n, q, P, dtype, gen, wt=None, timed=False):
    """P8 against its plain version on the reflectors of a P7 run (``wt``,
    else a fresh one): ct within UPDATE_TOL (bitwise printed), the plan's
    shared memory the C launcher's. Timed rows add the kernel by CUDA
    events and behind the sleep, the plain version's one call,
    torch.ormqr of the same reflectors (held to the kernel's ct), the
    bound and the chain bound."""
    if wt is None:
        _, wt = p7_case(torch, ho, npad, n, P, P - 1, dtype, gen)
    w, tau = wt
    ct = torch.randn((npad, q), generator=gen, device="cuda",
                     dtype=torch.float64).to(dtype)
    d = torch.zeros((P, q), dtype=dtype, device="cuda")
    d[:P - 1] = torch.randn((P - 1, q), generator=gen, device="cuda",
                            dtype=torch.float64).to(dtype)
    ck, cp = ct.clone(), ct.clone()
    ho.qr_append_apply(ck, d, w, tau, n)
    _, plain_ms = once_ms(torch, lambda: ho.qr_append_apply_plain(
        cp, d, w, tau, n))
    dt = dtype_name(dtype)
    err = rel_diff(torch, ck, cp)
    check(err <= UPDATE_TOL[dt] and same_bits(torch, ck, cp),
          f"qr_append_apply npad={npad} q={q} P={P} {dt}: {err} from the "
          "plain version, or not bit for bit")
    plan = ho.qr_append_apply_plan(q, P, dtype)
    check(plan.smem_bytes == ho.qr_append_apply_launch_smem(P, dtype),
          f"qr_append_apply P={P} {dt}: plan {plan} against the launcher's "
          f"{ho.qr_append_apply_launch_smem(P, dtype)} bytes")
    row = {"npad": npad, "n": n, "q": q, "P": P, "dtype": dt,
           "max_abs_err": err, "bitwise_equal": same_bits(torch, ck, cp),
           "launches_per_call": 1, "plan": plan._asdict()}
    if timed:
        c2 = ct.clone()
        row["ms"] = cuda_ms(lambda: ho.qr_append_apply(c2, d, w, tau, n))
        row["device_ms"] = device_ms(
            lambda: ho.qr_append_apply(c2, d, w, tau, n), launches=5)
        row["plain_ms"] = plain_ms
        # the same function as one LAPACK call: the reflectors [e_j; w_j]
        # in ormqr's form (implicit unit at row j, zeros to npad, w_j in
        # the last P rows), Qᴴ applied to [ct; d] (conj(tau): ormqr's
        # reflector is I − tau·v·vᴴ, applied conjugate-transposed)
        v = torch.zeros((npad + P, n), dtype=dtype, device="cuda")
        v[npad:] = w[:, :n]
        v.diagonal().fill_(1)
        taus = tau[:n].conj().contiguous()
        cd = torch.cat([ct, d])
        lib = torch.ormqr(v, taus, cd, left=True, transpose=True)
        lib_err = rel_diff(torch, lib[:npad], ck)
        check(lib_err <= UPDATE_TOL[dt], f"qr_append_apply npad={npad} "
              f"{dt}: torch.ormqr {lib_err} from the kernel")
        row["library_max_abs_err"] = lib_err
        row["library_ms"] = cuda_ms(lambda: torch.ormqr(
            v, taus, cd, left=True, transpose=True))
        del v, cd, lib
        it = ct.element_size()
        nbytes = (2 * npad * q + P * q + P * npad + npad) * it
        flops = 4.0 * n * q * P
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
        row["bound_chain_ms"] = p8_chain_bound(n, P, dt)
    return row


def p7_reflectors(torch, ho, npad, n, P, p_live, dtype, gen):
    """(w, tau) of P7's kernel on qr_append_operands (P7's own rows hold
    it to its plain version)."""
    r, u = qr_append_operands(torch, npad, n, P, p_live, dtype, gen)
    return ho.qr_append_build(r, u, n)


def update_kernel_rows(torch, ho, gen, n):
    """P6, P7 and P8 against their plain versions: first at the update
    phase's shapes in float32 (timed: the dense sweep at n, kb = 16 and
    kb = 1; the (1000, 256, 256) stack at kb = 2; untimed, at
    P6_UNTIMED_N under the n rows' CTA plan: kb = 4 up and down and the
    bfloat16 route at kb = 16; P7 at the 2n × n/2 qr
    operator's 16 appended rows; P8 at its 16-column solve, padded to 512
    columns, also timed in float64 and, at P8_COMPLEX_NPAD rows, in
    complex64 and complex128), then at 2048 in float32, float64, complex64 and complex128
    (an update and a failed downdate for P6), then P6's exact contracts.
    Returns (P6 rows, P7 rows, P8 rows, P6 invariants)."""
    f32 = torch.float32
    t0 = time.perf_counter()
    p6 = [p6_case(torch, ho, n, 16, f32, gen, scale=0.01, timed=True),
          p6_case(torch, ho, n, 1, f32, gen, scale=0.01, timed=True),
          p6_case(torch, ho, UPDATE_SMALL_N, 2, f32, gen, bsz=1000,
                  timed=True)]
    # the update phase's other instances, untimed, at P6_UNTIMED_N under
    # the same plan (CTAs of P6_ROWS rows; only their count differs):
    # k = 3 at bucket 4, the downdate that undoes it, and the refined
    # operator's bfloat16 route at kb = 16
    m = min(n, P6_UNTIMED_N)
    p6 += [p6_case(torch, ho, m, 4, f32, gen, scale=0.01, k=3),
           p6_case(torch, ho, m, 4, f32, gen, sign=-1, scale=0.005, k=3),
           p6_case(torch, ho, m, 16, torch.bfloat16, gen, scale=0.01)]
    check(p6[4]["info_max"] == 0, "chol_update_sweep: the downdate at "
          f"n = {m} failed")
    for r in p6[3:6]:
        full = ho.chol_update_plan_for(n, r["kb"], f32)
        check(r["plan"]["rows"] == full.rows and r["plan"]["bufs"]
              == full.bufs, f"chol_update_sweep n = {m}, kb = {r['kb']}: "
              f"plan {r['plan']} is not the n = {n} plan's CTA {full}")
    p7_main, wt = p7_case(torch, ho, n // 2, n // 2, 16, 16, f32, gen,
                          timed=True)
    p7 = [p7_main]
    p8 = [p8_case(torch, ho, n // 2, n // 2, 512, 16, f32, gen, wt=wt,
                  timed=True)]
    # the served shape in float64, the complex types at P8_COMPLEX_NPAD
    # rows, and a ragged one (n not a multiple of the chunk, q not of the
    # CTA's columns)
    p8 += [p8_case(torch, ho, r, r, 512, 16, dt, gen, timed=True,
                   wt=p7_reflectors(torch, ho, r, r, 16, 15, dt, gen))
           for dt, r in ((torch.float64, n // 2),
                         (torch.complex64, min(n // 2, P8_COMPLEX_NPAD)),
                         (torch.complex128, min(n // 2, P8_COMPLEX_NPAD)))]
    p8.append(p8_case(torch, ho, 2048, 1999, 200, 16, f32, gen))
    for dt in (f32, torch.float64, torch.complex64, torch.complex128):
        p6.append(p6_case(torch, ho, 2000, 4, dt, gen, k=3))
        p6.append(p6_case(torch, ho, 2000, 4, dt, gen, sign=-1, scale=3.0,
                          k=3))
        check(p6[-1]["info_max"] > 0, "chol_update_sweep: the downdate did "
              "not fail")
        row, wt = p7_case(torch, ho, 2048, 2000, 4, 3, dt, gen)
        p7.append(row)
        p8.append(p8_case(torch, ho, 2048, 2000, 24, 4, dt, gen, wt=wt))
    inv = p6_invariants(torch, ho, gen)
    inv["seconds"] = time.perf_counter() - t0
    return p6, p7, p8, inv


def spd_operand(torch, n, gen):
    """x·xᵀ/n + I in float32 (the main phase's SPD operand)."""
    x = torch.randn((n, n), generator=gen, device="cuda")
    a = x @ x.T / n
    a.diagonal().add_(1.0)
    return a


def spike_vectors(torch, n, k, a, gen):
    """(n, k) update vectors of four ±v entries per column at random rows,
    v = √‖A‖₁ / 8: ‖W‖₁² = ‖A‖₁/4, so each update charges exactly its
    rank to the update budget (obs/numerics.py), while A' differs from A
    by up to v² ≈ ‖A‖₁/64 in an entry, which a factor of the old operand
    would fail the residual gate on."""
    v = math.sqrt(a.abs().sum(dim=0).max().item()) / 8
    w = torch.zeros((n, k), device="cuda")
    rows = torch.randint(0, n, (4, k), generator=gen, device="cuda")
    signs = torch.randint(0, 2, (4, k), generator=gen, device="cuda") * 2 - 1
    w.scatter_(0, rows, v * signs.float())
    return w


def update_gate(torch, a64, X, B):
    """The worst ‖b − A'·x‖∞ / (n·ε·‖A'‖∞·‖x‖∞) of the served float32
    columns, computed in float64 against the float64 operand A' (ε of
    float32)."""
    x, b = X.double(), B.double()
    r = (b - a64 @ x).abs().max(dim=0).values
    scale = (a64.shape[0] * torch.finfo(torch.float32).eps
             * a64.abs().sum(dim=1).max() * x.abs().max(dim=0).values)
    return (r / scale).max().item()


def update_chol(torch, stt, ho, n, nb, gen):
    """The chol operator: warmup(nrhs=16, update_k=16), then updates at
    k = 1, 3, 16, the downdate that undoes the k = 3 one, an injected
    update_abort, and a downdate made indefinite on purpose. After each
    step 16 columns are served (a graph replay on the warmed plain
    operator), every column under the gate against A' in float64, the
    replay bit for bit the eager solve on the updated resident; on the
    happy path factors_total and aot_compiles do not move and the
    factor's storage is the warmed one."""
    from slate_tpu_torch.runtime import FaultPlan, FaultSpec
    dev = "cuda"
    a = spd_operand(torch, n, gen)
    a64 = a.double()
    sess = stt.Session(device=dev)
    h = sess.register(stt.hermitian(a, nb, stt.Uplo.Lower, device=dev),
                      op="chol")
    t0 = time.perf_counter()
    sess.warmup(h, nrhs=16, update_k=16)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    m = sess.metrics
    ptr = sess.factor(h).payload[0].data.data_ptr()
    base = {k: m.get(k) for k in ("factors_total", "aot_compiles")}
    steps = []
    w3 = None

    def step(label, w, downdate=False, happy=True):
        nonlocal a64
        sign = -1.0 if downdate else 1.0
        t0 = time.perf_counter()
        out = sess.update(h, w, downdate=downdate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        w64 = w.double()
        a64 = a64 + sign * (w64 @ w64.T)
        rec = {"step": label, "k": int(w.shape[1]), "wall_s": wall,
               "result": out}
        if out["info"] == 0:
            B = torch.randn((n, 16), generator=gen, device=dev)
            Bt = stt.from_dense(B, nb, device=dev)
            replays = m.get("graph_replays")
            X = sess.solve_matrix(h, Bt)
            rec["replayed"] = m.get("graph_replays") == replays + 1
            Xe = eager_solve(stt, "chol", sess.factor(h).payload, Bt)
            torch.cuda.synchronize()
            rec["replay_bitwise_eager"] = same_bits(
                torch, X.dense_canonical(), Xe.dense_canonical())
            rec["gate"] = update_gate(torch, a64, X.dense()[:n, :16], B)
            check(rec["replayed"] and rec["replay_bitwise_eager"]
                  and rec["gate"] <= RESIDUAL_BOUND,
                  f"update chol {label}: {rec}")
        if happy:
            check(out["applied"] and not out["refactored"]
                  and all(m.get(k) == v for k, v in base.items())
                  and sess.factor(h).payload[0].data.data_ptr() == ptr,
                  f"update chol {label}: left the happy path: {out}, "
                  f"{ {k: m.get(k) for k in base} }")
        steps.append(rec)
        return out

    for k in (1, 3, 16):
        w = spike_vectors(torch, n, k, a, gen)
        if k == 3:
            w3 = w
        step(f"update k={k}", w)
    step("downdate undoing k=3", w3, downdate=True)
    # the injected abort: the resident's factor bits stay as they were
    res0 = sess.factor(h)
    l_before = res0.payload[0].data.clone()
    sess.enable_faults(FaultPlan(seed=3, specs=(FaultSpec(
        "update_abort", rate=1.0, count=1),)))
    out = step("update_abort", spike_vectors(torch, n, 2, a, gen),
               happy=False)
    check(out["refactored"] and out["reason"] == "abort"
          and same_bits(torch, res0.payload[0].data, l_before)
          and m.get("update_aborts_total") == 1,
          f"update chol abort: {out}")
    refactor_s = steps[-1]["wall_s"]
    # a downdate made indefinite on purpose: refactored, never served
    wbad = torch.zeros((n, 1), device=dev)
    wbad[0, 0] = 100.0
    out = step("indefinite downdate", wbad, downdate=True, happy=False)
    check(out["refactored"] and out["reason"] == "downdate_indefinite"
          and out["info"] > 0 and m.get("update_downdate_failures_total") == 1,
          f"update chol indefinite downdate: {out}")
    try:
        sess.solve(h, torch.ones(n, device=dev))
        refused = False
    except stt.SlateError:
        refused = True
    check(refused, "update chol: the indefinite operator was served")
    counters = {k: m.get(k) for k in (
        "updates_total", "update_refactors_total", "update_aborts_total",
        "update_downdate_failures_total", "update_flops_total",
        "factors_total", "aot_compiles", "graph_replays")}
    sess.close()
    return {"n": n, "nb": nb, "warmup_s": warm_s,
            "refactor_s (the abort's)": refactor_s, "steps": steps,
            "counters": counters}, a


def update_qr(torch, stt, ho, n, nb, gen):
    """The 2n × n/2 qr operator: warmup(nrhs=16, update_k=16) (append
    slots and the appended solve's graph), 16 appended rows, one appended
    row deleted (applied), then a base row (a counted refactor). After
    each, 16 columns served and held within QR_REL_LIMIT of a float64
    normal-equations solve of the operand; the appended solves replay
    their graph bit for bit the eager solve, with factors_total and
    aot_compiles unchanged. The replayed 16-column solve is timed before
    the append and after it (``solve_replayed_16_ms``)."""
    dev = "cuda"
    m_q, n_q = 2 * n, n // 2
    aq = torch.randn((m_q, n_q), generator=gen, device=dev)
    sess = stt.Session(device=dev)
    h = sess.register(stt.from_dense(aq, nb, device=dev), op="qr")
    t0 = time.perf_counter()
    sess.warmup(h, nrhs=16, update_k=16)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    m = sess.metrics
    base = {k: m.get(k) for k in ("factors_total", "aot_compiles")}
    rows = aq
    steps = []

    def replayed_ms(mm):
        """The replayed 16-column solve of an mm-row right-hand side by
        CUDA events, median of 5 (after one warm-up), every call a
        replay."""
        bt = stt.from_dense(torch.randn((mm, 16), generator=gen, device=dev),
                            nb, device=dev)
        r0 = m.get("graph_replays")
        ms = cuda_ms(lambda: sess.solve_matrix(h, bt), reps=5)
        check(m.get("graph_replays") == r0 + 6,
              f"update qr: a timed {mm}-row solve did not replay its graph")
        return ms

    solve_ms = {"base": replayed_ms(m_q)}

    def serve(label, out, wall, happy):
        nonlocal rows
        mm = sess._ops[h].m
        B = torch.randn((mm, 16), generator=gen, device=dev)
        Bt = stt.from_dense(B, nb, device=dev)
        replays = m.get("graph_replays")
        X = sess.solve_matrix(h, Bt)
        replayed = m.get("graph_replays") == replays + 1
        Xe = eager_solve(stt, "qr", sess.factor(h).payload, Bt)
        torch.cuda.synchronize()
        ref = lstsq_normal64(torch, rows.double(), B)
        rec = {"step": label, "m": mm, "wall_s": wall, "result": out,
               "replayed": replayed,
               "replay_bitwise_eager": same_bits(
                   torch, X.dense_canonical(), Xe.dense_canonical()),
               "rel_err_max": max(rel_errors(torch, X.dense()[:n_q, :16],
                                             ref))}
        check(rec["rel_err_max"] <= QR_REL_LIMIT and (
            not happy or (replayed and rec["replay_bitwise_eager"]
                          and out["applied"] and not out["refactored"]
                          and all(m.get(k) == v for k, v in base.items()))),
              f"update qr {label}: {rec}")
        steps.append(rec)

    u = torch.randn((16, n_q), generator=gen, device=dev)
    t0 = time.perf_counter()
    out = sess.update(h, u)
    torch.cuda.synchronize()
    rows = torch.cat([aq, u])
    serve("append 16 rows", out, time.perf_counter() - t0, True)
    solve_ms["appended 16 rows"] = replayed_ms(m_q + 16)
    t0 = time.perf_counter()
    out = sess.update(h, delete=[m_q + 3])
    torch.cuda.synchronize()
    rows = torch.cat([aq, u[:3], u[4:]])
    serve("delete an appended row", out, time.perf_counter() - t0, True)
    t0 = time.perf_counter()
    out = sess.update(h, delete=[5])
    torch.cuda.synchronize()
    check(out["refactored"] and out["reason"] == "base_delete",
          f"update qr base delete: {out}")
    rows = torch.cat([aq[:5], aq[6:], u[:3], u[4:]])
    serve("delete a base row", out, time.perf_counter() - t0, False)
    counters = {k: m.get(k) for k in (
        "updates_total", "update_refactors_total", "update_flops_total",
        "factors_total", "aot_compiles", "graph_replays")}
    sess.close()
    return {"m": m_q, "n": n_q, "nb": nb, "warmup_s": warm_s,
            "steps": steps, "solve_replayed_16_ms": solve_ms,
            "counters": counters}


def update_small(torch, stt, ho, gen):
    """UPDATE_SMALL_OPS chol_small operators at n = UPDATE_SMALL_N: one
    update_small_batched at k = 2 (wall) beside the same updates as
    UPDATE_SMALL_OPS B = 1 Session.update calls on a second Session; every
    item's factor bit for bit its B = 1 one, every item served under the
    gate against A' in float64."""
    dev = "cuda"
    bsz, n = UPDATE_SMALL_OPS, UPDATE_SMALL_N
    x = torch.randn((bsz, n, n), generator=gen, device=dev)
    mats = x @ x.mT / n
    mats.diagonal(dim1=1, dim2=2).add_(1.0)
    del x
    ws = 0.05 * torch.randn((bsz, n, 2), generator=gen, device=dev)
    sessions = [stt.Session(device=dev) for _ in range(2)]
    handles = [[s.register(mats[i], op="chol_small") for i in range(bsz)]
               for s in sessions]
    zero = [torch.zeros(n, device=dev)] * bsz
    for s, hs in zip(sessions, handles):
        s.solve_small_batched(hs, zero)  # factor every operator at once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = sessions[0].update_small_batched(handles[0], list(ws))
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [sessions[1].update(h, ws[i]) for i, h in
               enumerate(handles[1])]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    check(all(o["applied"] and not o["refactored"] for o in outs + singles),
          "update_small_batched: an item left the happy path")
    lg = torch.stack([sessions[0].factor(h).payload[0] for h in handles[0]])
    l1 = torch.stack([sessions[1].factor(h).payload[0] for h in handles[1]])
    bitwise = same_bits(torch, lg, l1)
    b = torch.randn((bsz, n, 2), generator=gen, device=dev)
    xs, infos = sessions[0].solve_small_batched(handles[0], list(b))
    xs = torch.from_numpy(xs).to(dev).double()
    a2 = mats.double() + ws.double() @ ws.double().mT
    r = (b.double() - a2 @ xs).abs().amax(dim=(1, 2))
    gate = (r / (n * torch.finfo(torch.float32).eps
                 * a2.abs().sum(2).amax(1) * xs.abs().amax(dim=(1, 2))))
    check(bitwise and not any(infos) and gate.max().item() <= RESIDUAL_BOUND,
          f"update_small_batched: bitwise {bitwise}, gate "
          f"{gate.max().item()}")
    for s in sessions:
        s.close()
    return {"B": bsz, "n": n, "k": 2, "grouped_s": grouped_s,
            "b1_calls_s": single_s, "grouped_bitwise_b1": bitwise,
            "gate_max": gate.max().item()}


def update_refined(torch, stt, ho, a, n, nb, gen):
    """A bf16-refined chol operator on the chol operand ``a``: warmup
    (nrhs = 16, update_k = 16), one k = 16 update (the factor swept by P6's
    float32 instance on a float32 copy; the operand moves to the Session's
    storage, so the refine graphs are captured again, counted), then 16
    refined columns under the float32 gate against A' in float64."""
    dev = "cuda"
    sess = stt.Session(device=dev)
    h = sess.register(stt.hermitian(a, nb, stt.Uplo.Lower, device=dev),
                      op="chol", refine=stt.RefinePolicy("bfloat16"))
    sess.warmup(h, nrhs=16, update_k=16)
    m = sess.metrics
    compiles = m.get("aot_compiles")
    w = spike_vectors(torch, n, 16, a, gen)
    t0 = time.perf_counter()
    out = sess.update(h, w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    B = torch.randn((n, 16), generator=gen, device=dev)
    X = sess.solve_matrix(h, stt.from_dense(B, nb, device=dev))
    a64 = a.double() + w.double() @ w.double().T
    gate = update_gate(torch, a64, X.dense()[:n, :16], B)
    check(out["applied"] and gate <= RESIDUAL_BOUND,
          f"update refined chol: {out}, gate {gate}")
    rec = {"n": n, "k": 16, "wall_s": wall, "result": out, "gate": gate,
           "factor_dtype": str(sess.factor(h).payload[0].dtype),
           "recaptured_graphs": m.get("aot_compiles") - compiles,
           "refine_iterations": m.snapshot()["histograms"][
               "refine_iterations"]["sum"]}
    sess.close()
    return rec


def update_phase(torch, stt, ho, n, nb, gen):
    """Phase 9 (see the module docstring)."""
    t0 = time.perf_counter()
    chol, a = update_chol(torch, stt, ho, n, nb, gen)
    torch.cuda.empty_cache()
    qr = update_qr(torch, stt, ho, n, nb, gen)
    torch.cuda.empty_cache()
    small = update_small(torch, stt, ho, gen)
    torch.cuda.empty_cache()
    refined = update_refined(torch, stt, ho, a, n, nb, gen)
    del a
    torch.cuda.empty_cache()
    return {"chol": chol, "qr": qr, "chol_small": small,
            "refined_chol": refined, "seconds": time.perf_counter() - t0}


def complex_spills(_build):
    """ptxas's registers and spill stores for every complex instance (Cx
    in the mangled name) of the sources this run built, and for every
    instance of P6 (chol_update), P7 and P8 (qr_append), from the build
    log; names demangled by c++filt where it is installed."""
    rows = [{k: v for k, v in r.items() if k != "mangled"}
            for r in ptxas_rows(_build)
            if "2CxI" in r["mangled"] or r["source"] in ("chol_update",
                                                         "qr_append")]
    check(rows or not _build.BUILD_LOG,
          "the build log shows no complex instance")
    return rows


def ptxas_rows(_build, sources=None):
    """ptxas's registers and spill stores for every function of the
    sources this run built (every source, or those of ``sources``), from
    the build log; names demangled by c++filt where it is installed
    ("mangled" keeps ptxas's own)."""
    import re
    import shutil
    rows = []
    for src, log in sorted(_build.BUILD_LOG.items()):
        if sources is not None and src not in sources:
            continue
        fn, spill = None, 0
        for line in log["ptxas"].splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                rows.append({"source": src, "function": fn, "mangled": fn,
                             "registers": int(m.group(1)),
                             "spill_stores": spill})
                fn, spill = None, 0
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        out = subprocess.run([cxxfilt], input="\n".join(
            r["function"] for r in rows), capture_output=True, text=True,
            timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, name in zip(rows, names):
                r["function"] = name
    return rows


# ---------------------------------------------------------------------------
# P9 (the secular roots of stedc's merges) and stedc on its own
# ---------------------------------------------------------------------------

# the first: a merge at the top of n = 8192; 64: half of stedc's merges
P9_KS = (4096, 512, 16384, 64)
P9_SPECTRA = ("random", "clustered", "tiny_z")
P9_DEVICE_LAUNCHES = 10      # P9 launches queued behind the sleep
P9_PASSES = 62               # pole choice, 55 bisections, 4 Newton, 2 fixed
P9_RECIP_ULPS = 2.0          # the kernel's reciprocal against IEEE division
STEDC_N = 4096
STEDC_KINDS = ("random", "glued_wilkinson", "ties")
# tests/test_stedc.py's torture bounds, as multiples of n
STEDC_VALUE_C = 1e-13  # |w − scipy's| ≤ n·c·max(1, |w|)
STEDC_ORTH_C = 1e-13   # ‖ZᵀZ − I‖max < n·c
STEDC_RES_C = 1e-12    # ‖T·Z − Z·Λ‖max < n·c·max(1, |w|)


def p9_spectrum(kind, k, rng):
    """A merge's (δ ascending, z unit, ρ) after deflation: δ Gaussian
    ("random"); half of δ 1e-9 to 2e-9 apart in one cluster
    ("clustered"); or every third z 1e-7 of the others, whose roots sit
    against their poles ("tiny_z")."""
    import numpy as np
    if kind == "clustered":
        delta = np.sort(np.concatenate([
            0.3 + np.cumsum(rng.uniform(1e-9, 2e-9, k // 2)),
            rng.uniform(-2.0, 2.0, k - k // 2)]))
    else:
        delta = np.sort(rng.standard_normal(k))
    z = rng.standard_normal(k)
    if kind == "tiny_z":
        z[::3] *= 1e-7
    return delta, z / np.linalg.norm(z), 0.7


def p9_case(torch, ho, k, kind, rng):
    """P9 against its plain version on the card at k roots: the roots
    λ = δ[shift] + μ within SECULAR_ROOT_C·ε·max(max|δ|, ρ) (a pole
    choice flipped where f at the midpoint is within rounding of zero
    moves μ, not λ: counted as "flipped"), and the merge's eigenvectors
    built from the kernel's (shift, μ) orthogonal to k·SECULAR_ORTH.
    Timed by CUDA events (median of 3 after a warm-up), device ms (queued
    behind the sleep), the plain version's one call, and the library
    yardstick torch.linalg.eigvalsh of the dense k × k diag(δ) + ρ·z·zᵀ,
    which has the same roots; the bound counts 61·k² pole terms at 3
    float64 operations each at the FMA rate."""
    import numpy as np
    from slate_tpu_torch.linalg import stedc as sd
    delta_np, z_np, rho = p9_spectrum(kind, k, rng)
    delta = torch.as_tensor(delta_np, device="cuda")
    z2 = torch.as_tensor(z_np * z_np, device="cuda")
    up, mu = ho.secular_roots(delta, z2, rho)
    (up_p, mu_p), plain_ms = once_ms(
        torch, lambda: ho.secular_roots_plain(delta, z2, rho))
    idx = torch.arange(k, device="cuda")
    shift = idx + up.long()
    lam = delta[shift] + mu
    lam_p = delta[idx + up_p.long()] + mu_p
    err = float((lam - lam_p).abs().max())
    scale = max(float(np.abs(delta_np).max()), rho)
    tol = ho.SECULAR_ROOT_C * float(np.finfo(np.float64).eps) * scale
    check(err <= tol and bool(torch.isfinite(mu).all()),
          f"secular_roots: k = {k} {kind}: roots {err} off the plain "
          f"version's (tolerance {tol})")
    V = sd._vectors(delta_np, z_np, rho, shift, mu)
    orth = float((V.T @ V - torch.eye(k, dtype=V.dtype,
                                      device="cuda")).abs().max())
    del V
    check(orth < k * ho.SECULAR_ORTH, f"secular_roots: k = {k} {kind}: "
          f"eigenvectors {orth} from orthogonal")
    up2, mu2 = ho.secular_roots(delta, z2, rho)
    same = bool(torch.equal(up, up2)) and bool(torch.equal(
        mu.view(torch.int64), mu2.view(torch.int64)))
    check(same, f"secular_roots: k = {k} {kind}: two launches differ")
    plan = ho.secular_roots_plan(k)
    check(tuple(plan) == p9_built_plan(ho, k), f"secular_roots: k = {k}: "
          f"plan {tuple(plan)} is not the kernel's {p9_built_plan(ho, k)}")
    row = {"k": k, "spectrum": kind, "dtype": "float64", "rho": rho,
           "max_abs_err": err, "tolerance": tol,
           "flipped": int((up != up_p).sum()), "orthogonality": orth,
           "deterministic": same, "plan": plan._asdict(),
           "ptxas": p9_ptxas(plan)}

    def run():
        ho.secular_roots(delta, z2, rho)
    row["ms"] = cuda_ms(run, reps=3)
    row["device_ms"] = device_ms(run, P9_DEVICE_LAUNCHES)
    chain = P9_PASSES * -(-k // plan.lanes)  # terms a lane sums a launch
    row["ns_per_chain_term"] = row["device_ms"] * 1e6 / chain
    row["ns_per_term_lane"] = row["device_ms"] * 1e6 / (k * chain)
    row["plain_ms"] = plain_ms
    row["bound_ms"], row["bound_by"] = bound(2 * k * 8 + k * 9, 61 * k * k * 3,
                                             "float64", FMA_FLOPS)
    zt = torch.as_tensor(z_np, device="cuda")
    dense = torch.diag(delta) + rho * torch.outer(zt, zt)
    w_lib, row["library_ms"] = once_ms(
        torch, lambda: torch.linalg.eigvalsh(dense))
    row["library_max_diff"] = float((w_lib - lam.sort().values).abs().max())
    row["library"] = "torch.linalg.eigvalsh (dense k × k)"
    return row


def p9_built_plan(ho, k):
    """The plan the built kernel launches at k (its plan_for)."""
    import ctypes
    out = (ctypes.c_int * 5)()
    rc = ho._fn("secular", "slate_secular_plan",
                [ctypes.c_int, ctypes.c_void_p])(k, ctypes.addressof(out))
    check(rc == 0, f"slate_secular_plan({k}) returned {rc}")
    return out[0], out[1], out[2], bool(out[3]), out[4]


def p9_ptxas(plan):
    """ptxas's registers and spill stores for the kernel instance that
    ``plan`` launches (secular_roots_kernel<lanes, resident>)."""
    from slate_tpu_torch.ops import _build
    want = (f"secular_roots_kernel<{plan.lanes}, "
            f"{str(plan.resident).lower()}>")
    mangled = f"secular_roots_kernelILi{plan.lanes}ELb{int(plan.resident)}E"
    rows = [r for r in ptxas_rows(_build, ("secular",))
            if want in r["function"] or mangled in r["mangled"]]
    return {k: rows[0][k] for k in ("function", "registers",
                                    "spill_stores")} if rows else None


def p9_recip(torch, ho):
    """The kernel's reciprocal of a clamped denominator against IEEE
    division (torch's 1/x) on 2²⁰ denominators, mantissas uniform, both
    signs, exponents uniform over 1e-300 ≤ |den| ≤ 1e300, and ±0 and
    subnormals (clamped to ±1e-300, sign kept, a zero to +1e-300):
    the largest error in ulps of the exact quotient."""
    import ctypes
    import numpy as np
    rng = np.random.default_rng(1)
    n = 1 << 20
    x = (rng.uniform(1.0, 2.0, n) * 10.0 ** rng.uniform(-300, 300, n)
         * rng.choice([-1.0, 1.0], n))
    x[:6] = [0.0, -0.0, 5e-324, -5e-324, 1e-310, -2e-308]
    xt = torch.as_tensor(x, device="cuda")
    out = torch.empty_like(xt)
    f = ho._fn("secular", "slate_secular_recip_f64",
               [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])
    rc = f(xt.data_ptr(), out.data_ptr(), n,
           torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"slate_secular_recip_f64 returned {rc}")
    got = out.cpu().numpy()
    clamped = np.where(np.abs(x) < 1e-300,
                       np.where(x < 0, -1e-300, 1e-300), x)
    exact = 1.0 / clamped
    ulps = np.abs(got - exact) / np.spacing(np.abs(exact))
    row = {"n": n, "max_ulps": float(ulps.max()),
           "mean_ulps": float(ulps.mean()),
           "share_not_rounded_to_nearest": float((got != exact).mean()),
           "tiny_and_zero": got[:6].tolist()}
    check(bool(np.isfinite(got).all()) and row["max_ulps"] <= P9_RECIP_ULPS
          and bool(np.all(np.sign(got) == np.sign(clamped))),
          f"secular_roots: the reciprocal is {row['max_ulps']} ulps off")
    return row


def p9_rows(torch, ho, rng):
    """P9 at every k of P9_KS on every spectrum of P9_SPECTRA (the first
    row, k = 4096 random, is the kernels line's), and its reciprocal."""
    rows = [p9_case(torch, ho, k, kind, rng) for k in P9_KS
            for kind in P9_SPECTRA]
    return rows, p9_recip(torch, ho)


def stedc_tridiagonal(kind, n, rng):
    """stedc's three arms at order n: a Gaussian tridiagonal ("random":
    secular roots), glued Wilkinson matrices W21⁺ joined by 1e-9
    ("glued_wilkinson": near-equal pairs, rotations) and d = 1, e = 1e-12
    ("ties": almost everything deflates)."""
    import numpy as np
    if kind == "random":
        return rng.standard_normal(n), rng.standard_normal(n - 1)
    if kind == "glued_wilkinson":
        m = 21
        d = np.concatenate([np.abs(np.arange(m) - (m - 1) / 2.0)]
                           * -(-n // m))[:n]
        e = np.ones(n - 1)
        e[m - 1::m] = 1e-9
        return d, e
    return np.ones(n), np.full(n - 1, 1e-12)


def tridiag_times(torch, d, e, z):
    """T·Z for the tridiagonal (d, e) (tensors on Z's device)."""
    tz = d[:, None] * z
    tz[:-1] += e[:, None] * z[1:]
    tz[1:] += e[:, None] * z[:-1]
    return tz


def stedc_p9_profile(torch, ho, stedc, d, e):
    """stedc on (d, e) once more under torch.profiler: P9's device ms
    summed over its launches (secular_roots_kernel events), their count
    beside the wrapper's launches (a profiler has been seen to drop one
    event of a window: a small kernel opens it), and the profiled
    wall."""
    from torch.profiler import ProfilerActivity, profile
    before = ho.LAUNCHES["secular_roots"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stedc(d, e, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mine = [ev for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")
            and "secular_roots_kernel" in ev.key]
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) for ev in mine)
    count = sum(ev.count for ev in mine)
    launches = ho.LAUNCHES["secular_roots"] - before
    check(us > 0 and 0 < count <= launches, f"stedc: the profiler saw "
          f"{count} P9 launches ({us} µs), the wrapper {launches}")
    return {"p9_device_ms": us / 1e3, "p9_profiled_launches": count,
            "p9_launches": launches, "profiled_wall_s": wall}


def stedc_case(torch, ho, kind, n, rng, failures):
    """stedc alone on the card: its wall (host clock ending in a sync),
    P9's launches, and scipy.linalg.eigh_tridiagonal's wall (with
    vectors, on the host) on the same (d, e); the gates of STEDC_*_C
    against scipy's eigenvalues. A failed gate is appended to
    ``failures``."""
    import numpy as np
    from scipy.linalg import eigh_tridiagonal
    from slate_tpu_torch.linalg.stedc import stedc
    d, e = stedc_tridiagonal(kind, n, rng)
    before = ho.LAUNCHES["secular_roots"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, z = stedc(d, e, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ho.LAUNCHES["secular_roots"] - before
    t0 = time.perf_counter()
    w_ref, _ = eigh_tridiagonal(d, e)
    scipy_s = time.perf_counter() - t0
    scale = max(1.0, float(np.abs(w_ref).max()))
    dt, et, wt = (torch.as_tensor(x, device="cuda") for x in (d, e, w))
    row = {"case": kind, "n": n, "wall_s": wall,
           "secular_roots_launches": launches, "scipy_s": scipy_s,
           "value_err": float(np.abs(w - w_ref).max()) / scale,
           "orthogonality": float((z.T @ z - torch.eye(
               n, dtype=z.dtype, device="cuda")).abs().max()),
           "residual": float((tridiag_times(torch, dt, et, z)
                              - z * wt[None, :]).abs().max()) / scale}
    del z
    if kind == "random":  # P9's device time inside stedc, by the profiler
        row.update(stedc_p9_profile(torch, ho, stedc, d, e))
    if not (row["value_err"] <= n * STEDC_VALUE_C
            and row["orthogonality"] < n * STEDC_ORTH_C
            and row["residual"] < n * STEDC_RES_C):
        failures.append(f"stedc {kind} at n = {n}: eigenvalues "
                        f"{row['value_err']}, orthogonality "
                        f"{row['orthogonality']}, residual {row['residual']}")
    emit("stedc_case", **row)
    return row


# ---------------------------------------------------------------------------
# phase 10: Hermitian eigensolvers
# ---------------------------------------------------------------------------

EIG_N = 4096          # hegv, and DC with vectors in float64
# heev QR with vectors (cut by the host steqr), and DC float32 and Auto
# (repeats of EIG_N's DC float64, cut for the smoke's time)
EIG_VEC_N = 2048
EIG_NB = 256
EIG_VALUES_N = 8192   # values only: the steqr cap (QR, and DC)
EIG_REDIRECT_N = EIG_VALUES_N + EIG_NB  # QR above the cap: warns, runs DC
EIG_AUTO_N = 2000     # Auto's band-dense path, uneven n
EIG_COMPLEX_N = 2048
# heev QR with vectors in float32, complex128 and complex64: the same host
# steqr as float64's at EIG_VEC_N (7.8–8.6 s a call there), so these run
# smaller to keep the smoke inside its time
EIG_REPEAT_N = 1024
EIG_CHAIN_N = 1024    # he2td's and hb2td's launches counted by the profiler
EIG_GATE = 500.0      # tests/test_eig_svd.py's residual and orthogonality
EIG_VALUE_TOL = {"float64": 1e-9, "complex128": 1e-9, "float32": 1e-4,
                 "complex64": 1e-4}
HEGV_TOL = 1e-10
def eig_operator(torch, n, complex_, rng):
    """A Hermitian n × n operator on the card with a spectrum known in
    advance, Q·diag(λ)·Qᴴ in float64 (complex128): λ uniform in [−1, 1]
    and the Gaussian whose QR gives Q drawn by numpy; returns (A, λ)."""
    import numpy as np
    lam = np.sort(rng.uniform(-1.0, 1.0, n))
    g = rng.standard_normal((n, n))
    if complex_:
        g = g + 1j * rng.standard_normal((n, n))
    q, _ = torch.linalg.qr(torch.as_tensor(g, device="cuda"))
    a = (q * torch.as_tensor(lam, device="cuda").to(q.dtype)) @ q.mH
    return 0.5 * (a + a.mH), lam


@contextlib.contextmanager
def stage_timer(torch, hooks, host_stages):
    """Times the stage functions a driver calls while in use (``hooks``:
    ``obs/stages.wrapped_stages`` for heev and hegv, ``wrapped_svd_stages``
    for svd): CUDA events around the device stages (synchronized after
    each), the host clock ending in a sync around ``host_stages`` (steqr
    on the host; stedc's merges, and bdsqr's, alternate host and device
    work); yields the ms summed by stage. A stage nested in another is
    timed inside it too (svd's bdsqr holds its stedc)."""
    ms = {}

    def timed(name, fn):
        def run(*args, **kw):
            if name in host_stages:
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                took = (time.perf_counter() - t0) * 1e3
            else:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args, **kw)
                e1.record()
                e1.synchronize()
                took = e0.elapsed_time(e1)
            ms[name] = ms.get(name, 0.0) + took
            return out
        return run

    with hooks(timed):
        yield ms


def eig_stage_timer(torch):
    from slate_tpu_torch.obs.stages import wrapped_stages
    return stage_timer(torch, wrapped_stages, ("steqr", "stedc"))


def yardstick_ms(torch, fn, a):
    """One timed call of a torch.linalg function (cuSOLVER) on the card's
    operand, after a warm-up at 256², in ms by CUDA events."""
    fn(a[:256, :256])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn(a)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def eig_case(torch, stt, flops, a64, lam, dtype, label, opts,
             vectors, memo, failures):
    """heev of ``a64`` rounded to ``dtype`` at EIG_NB under ``opts``: wall
    (host clock ending in a sync), per-stage ms, GFLOP/s by the flop
    model, torch.linalg.eigh's (eigvalsh's) ms on the same operand; with
    vectors the residual and orthogonality gates and the eigenvalues
    against numpy's float64 eigvalsh of the same matrix, values only
    against λ. ``memo`` keeps the host eigvalsh and the yardstick per
    shape and type; a failed gate is appended to ``failures``."""
    import numpy as np
    n = a64.shape[0]
    a = a64.to(dtype)
    A = stt.hermitian(torch.tril(a), EIG_NB, stt.Uplo.Lower, device="cuda")
    torch.cuda.synchronize()
    with eig_stage_timer(torch) as stages:
        t0 = time.perf_counter()
        w, Z = stt.heev(A, opts, want_vectors=vectors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dt = dtype_name(dtype)
    model = (flops.heev_2stage(n) if opts.eig_stage1 == "two_stage"
             else flops.heev(n, vectors))
    row = {"case": label, "n": n, "nb": EIG_NB, "dtype": dt,
           "method": opts.method_eig.value, "stage1": opts.eig_stage1,
           "vectors": vectors, "wall_s": wall,
           "gflops": model / wall / 1e9, "stages_ms": dict(stages)}
    norm_a = float(np.abs(lam).max())
    if vectors:
        eps = torch.finfo(w.dtype).eps
        aw, z, wd = wide(torch, a), wide(torch, Z.dense()[:n, :n]), \
            wide(torch, w)
        row["residual"] = float(
            torch.linalg.matrix_norm(aw @ z - z * wd[None, :], 1)
            / (n * eps * torch.linalg.matrix_norm(aw, 1)))
        row["orthogonality"] = float(torch.linalg.matrix_norm(
            z.mH @ z - torch.eye(n, dtype=z.dtype, device=z.device), 1)
            / (n * eps))
        if ("ref", n, dt) not in memo:
            memo[("ref", n, dt)] = np.linalg.eigvalsh(aw.cpu().numpy())
        ref = memo[("ref", n, dt)]
        if not (row["residual"] < EIG_GATE
                and row["orthogonality"] < EIG_GATE):
            failures.append(f"heev {label}: residual {row['residual']} / "
                            f"orthogonality {row['orthogonality']} over "
                            f"{EIG_GATE}")
    else:
        ref = lam
    row["value_err_rel"] = float(np.abs(w.double().cpu().numpy()
                                        - ref).max()) / norm_a
    if not row["value_err_rel"] < EIG_VALUE_TOL[dt]:
        failures.append(f"heev {label}: eigenvalues "
                        f"{row['value_err_rel']}·‖A‖ off")
    key = ("yardstick", n, dt, vectors)
    if key not in memo:
        memo[key] = yardstick_ms(torch, torch.linalg.eigh if vectors
                                 else torch.linalg.eigvalsh, a)
    row["yardstick_ms"] = {("eigh" if vectors else "eigvalsh"): memo[key]}
    emit("eig_case", **row)
    return row


def chain_events(torch, fn):
    """Device events (kernels, copies, sets: the host's launches) of one
    call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA"))


def eig_chains(torch, stt, rng, cases):
    """The two sequential chains that would be port-only kernel
    candidates: he2td's latrd column (device events a column by the
    profiler at n = EIG_CHAIN_N; µs a column and the columns' matrix-
    vector bytes bound in every case that ran he2td) and hb2td's hop
    (events a hop at EIG_CHAIN_N with b = EIG_NB; hops and µs a hop in
    every case that ran the chase)."""
    from slate_tpu_torch.linalg.eig import chase_hops
    a, _ = eig_operator(torch, EIG_CHAIN_N, False, rng)
    A = stt.hermitian(torch.tril(a), EIG_NB, stt.Uplo.Lower, device="cuda")
    stt.he2td(A)
    td_events = chain_events(torch, lambda: stt.he2td(A))
    band, _ = stt.he2hb(A)
    hb_events = chain_events(torch, lambda: stt.hb2td(band))
    latrd, hops = [], []
    for r in cases:
        npad = -(-r["n"] // EIG_NB) * EIG_NB
        item = 16 if r["dtype"] == "complex128" else {
            "float32": 4, "float64": 8, "complex64": 8}[r["dtype"]]
        if "he2td" in r["stages_ms"]:
            latrd.append({
                "case": r["case"], "columns": npad - 1,
                "us_per_column": r["stages_ms"]["he2td"] * 1e3 / (npad - 1),
                "matvec_bytes_bound_ms": sum(
                    (npad - 1 - j) ** 2 for j in range(npad - 1))
                * item / PEAK_BYTES_PER_S * 1e3})
        if "hb2td" in r["stages_ms"]:
            h = sum(chase_hops(npad, EIG_NB))
            hops.append({"case": r["case"], "hops": h,
                         "us_per_hop": r["stages_ms"]["hb2td"] * 1e3 / h})
    return {"latrd_column": {"events_per_column_at_1024":
                             td_events / (EIG_CHAIN_N - 1), "cases": latrd},
            "bulge_hop": {"events_per_hop_at_1024": hb_events / sum(
                chase_hops(EIG_CHAIN_N, EIG_NB)), "cases": hops}}


def eig_phase(torch, stt, ho, seed):
    """heev, hegv and stedc on the card (see the module docstring, phase
    10). Returns (row, launches, launches by type); the row's "failures"
    lists every gate that failed."""
    import warnings

    import numpy as np
    from slate_tpu_torch.obs import flops
    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    rng = np.random.default_rng(seed)
    qr = stt.Options(method_eig=stt.MethodEig.QR)
    two = stt.Options(method_eig=stt.MethodEig.QR, eig_stage1="two_stage")
    dc = stt.Options(method_eig=stt.MethodEig.DC)
    dc_two = stt.Options(method_eig=stt.MethodEig.DC, eig_stage1="two_stage")
    auto = stt.Options()
    memo, failures, cases = {}, [], []
    t_phase = time.perf_counter()
    ho.reset_launches()

    def run(a, lam, specs, vectors=True):
        for dt, name, o in specs:
            cases.append(eig_case(torch, stt, flops, a, lam, dt,
                                  f"{name}_{dtype_name(dt)}", o, vectors,
                                  memo, failures))

    # stedc alone on its three arms
    stedc_rows = [stedc_case(torch, ho, kind, STEDC_N, rng, failures)
                  for kind in STEDC_KINDS]
    # (a), (b) QR with vectors through both stage-1 paths, and DC through
    # two_stage
    a_vec, lam = eig_operator(torch, EIG_VEC_N, False, rng)
    run(a_vec, lam, [(f64, name, o)
                     for name, o in (("qr", qr), ("two_stage", two))])
    # (g) DC with vectors in float32 and Auto in float64 at EIG_VEC_N,
    # where Auto takes stedc from n alone (n = its threshold)
    run(a_vec, lam, [(f32, "dc", dc), (f64, "auto_dc", auto)])
    if "stedc" not in cases[-1]["stages_ms"]:
        failures.append(f"heev Auto at n = {EIG_VEC_N} did not run stedc")
    # (a), (b), (e) in the other types, at EIG_REPEAT_N: float32, then
    # complex128 and complex64 through both stage-1 paths under QR; and
    # DC through two_stage in float64 (the served eig operator's stages,
    # which the spectral phase runs at 4096)
    a, lam = eig_operator(torch, EIG_REPEAT_N, False, rng)
    run(a, lam, [(f64, "dc_two_stage", dc_two)])
    run(a, lam, [(f32, name, o)
                 for name, o in (("qr", qr), ("two_stage", two))])
    a, lam = eig_operator(torch, EIG_REPEAT_N, True, rng)
    run(a, lam, [(dt, name, o) for dt in (c128, c64)
                 for name, o in (("qr", qr), ("two_stage", two))])
    # (e) complex under DC
    a, lam = eig_operator(torch, EIG_COMPLEX_N, True, rng)
    run(a, lam, [(dt, "dc", dc) for dt in (c128, c64)])
    # (d) Auto's band-dense path at an uneven n
    a, lam = eig_operator(torch, EIG_AUTO_N, False, rng)
    run(a, lam, [(f64, "auto", auto), (f32, "auto", auto)])
    # (c) values only at the steqr cap, float32, under QR and DC
    a, lam = eig_operator(torch, EIG_VALUES_N, False, rng)
    run(a, lam, [(f32, "qr_values", qr), (f32, "dc_values", dc)],
        vectors=False)
    del a, a_vec
    torch.cuda.empty_cache()
    # (h) QR above the cap warns as the reference does and runs DC
    a, lam = eig_operator(torch, EIG_REDIRECT_N, False, rng)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        run(a, lam, [(f32, "qr_redirect_values", qr)], vectors=False)
    redirect = [str(r.message) for r in rec
                if issubclass(r.category, RuntimeWarning)]
    if not (len(redirect) == 1 and f"redirecting n={EIG_REDIRECT_N} to "
            "MethodEig.DC" in redirect[0]
            and "stedc" in cases[-1]["stages_ms"]
            and "steqr" not in cases[-1]["stages_ms"]):
        failures.append(f"heev QR at n = {EIG_REDIRECT_N}: warnings "
                        f"{redirect}, stages {sorted(cases[-1]['stages_ms'])}")
    del a
    torch.cuda.empty_cache()
    # (g) DC with vectors at EIG_N in float64
    a, lam = eig_operator(torch, EIG_N, False, rng)
    run(a, lam, [(f64, "dc", dc)])
    del a
    torch.cuda.empty_cache()
    heev_launches, heev_types = launch_snapshot(ho)
    if not heev_launches["secular_roots"] > 0:
        failures.append("heev and stedc launched no secular_roots")
    # the chains' profiled runs are not the main path's: not counted
    chains = eig_chains(torch, stt, rng, cases)
    # (f) hegv itype 1 under Auto: potrf (K1, P1), hegst (trsm: P1), heev
    # DC (P1 in he2td's larft, P9 in stedc), trsm
    n = EIG_N
    a_g, _ = eig_operator(torch, n, False, rng)
    g = torch.as_tensor(rng.standard_normal((n, n)), device="cuda")
    b = g @ g.T / n + torch.eye(n, dtype=f64, device="cuda")
    A = stt.hermitian(torch.tril(a_g), EIG_NB, stt.Uplo.Lower,
                      device="cuda")
    B = stt.hermitian(torch.tril(b), EIG_NB, stt.Uplo.Lower, device="cuda")
    ho.reset_launches()
    torch.cuda.synchronize()
    with eig_stage_timer(torch) as stages:
        t0 = time.perf_counter()
        w, X, info = stt.hegv(A, B, auto)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    hegv_launches, hegv_types = launch_snapshot(ho)
    x = X.dense()[:n, :n]
    res = float(torch.linalg.matrix_norm(a_g @ x - (b @ x) * w[None, :], 1)
                / (torch.linalg.matrix_norm(a_g, 1) * n))
    # model: potrf n³/3, heev's 10n³/3, and n³ for each of hegst's two
    # triangular solves and the back-transform's
    hegv = {"n": n, "nb": EIG_NB, "dtype": "float64", "itype": 1,
            "method": "auto", "info": int(info), "wall_s": wall,
            "gflops": (flops.potrf(n) + flops.heev(n, True) + 3 * n ** 3)
            / wall / 1e9,
            "stages_ms": dict(stages), "generalized_residual": res,
            "launches": {k: v for k, v in hegv_launches.items() if v}}
    emit("eig_case", case="hegv_float64", **hegv)
    if not (int(info) == 0 and res < HEGV_TOL and "stedc" in stages):
        failures.append(f"hegv: info {int(info)}, generalized residual "
                        f"{res}, stages {sorted(stages)}")
    for k in ("chol_tile", "trtri_leaves", "secular_roots"):
        if not hegv_launches[k] > 0:
            failures.append(f"hegv launched no {k}")
    del a_g, b, g, A, B, X
    torch.cuda.empty_cache()
    launches = {k: v + heev_launches[k] for k, v in hegv_launches.items()}
    types = {k: dict(v) for k, v in heev_types.items()}
    for k, by in hegv_types.items():
        for dt, v in by.items():
            types[k][dt] = types[k].get(dt, 0) + v
    row = {"stedc": stedc_rows, "cases": cases, "hegv": hegv,
           "chains": chains, "qr_redirect_warning": redirect,
           "host_cpus": os.cpu_count(),
           "torch_threads": torch.get_num_threads(),
           "seconds": time.perf_counter() - t_phase, "failures": failures}
    return row, launches, types


# ---------------------------------------------------------------------------
# phase 11: the SVD
# ---------------------------------------------------------------------------

SVD_N = 8192          # the reference's svd row: bench_svd(8192, 1024, f32)
SVD_NB = 1024
SVD_COND = 100.0      # σ geometric from 1 to 1/SVD_COND (svd_geo)
SVD_CHAIN_N = 1024    # ge2bd's labrd column: device events by the profiler
SVD_GATE = 500.0      # the eig phase's bounds, in units of ε
SVD_VALUE_TOL = {"float64": 1e-9, "complex128": 1e-9, "float32": 1e-4,
                 "complex64": 1e-4}


def svd_operator(torch, m, n, complex_, rng, rank=None):
    """U·diag(σ)·Vᴴ on the card in float64 (complex128): U (m × k) and
    V (n × k) from the QR of Gaussians drawn by numpy, σ geometric from
    1 to 1/SVD_COND over the first ``rank`` (all k = min(m, n) by
    default), zero beyond. Returns (A, σ descending as numpy)."""
    import numpy as np
    k = min(m, n)
    r = k if rank is None else rank
    sig = np.zeros(k)
    sig[:r] = np.geomspace(1.0, 1.0 / SVD_COND, r)

    def basis(rows):
        g = rng.standard_normal((rows, k))
        if complex_:
            g = g + 1j * rng.standard_normal((rows, k))
        q, _ = torch.linalg.qr(torch.as_tensor(g, device="cuda"))
        return q

    u = basis(m)
    v = basis(n)
    return (u * torch.as_tensor(sig, device="cuda").to(u.dtype)) @ v.mH, sig


def svd_stage_timer(torch):
    from slate_tpu_torch.obs.stages import wrapped_svd_stages
    return stage_timer(torch, wrapped_svd_stages, ("bdsqr", "stedc"))


def svd_gates(torch, a, s, U, V):
    """(‖A − U·Σ·Vᴴ‖₁/(‖A‖₁·max(m, n)·ε), ‖UᴴU − I‖₁/(m·ε),
    ‖VᴴV − I‖₁/(n·ε)) in float64 (complex128), ε of A's type."""
    m, n = a.shape
    k = min(m, n)
    eps = torch.finfo(s.dtype).eps
    aw = wide(torch, a)
    u = wide(torch, U.dense()[:m, :k])
    v = wide(torch, V.dense()[:n, :k])
    sw = s.double().to(u.dtype)
    rec = torch.linalg.matrix_norm(aw - (u * sw[None, :]) @ v.mH, 1) / (
        torch.linalg.matrix_norm(aw, 1) * max(m, n) * eps)
    eye = torch.eye(k, dtype=u.dtype, device=u.device)
    ou = torch.linalg.matrix_norm(u.mH @ u - eye, 1) / (m * eps)
    ov = torch.linalg.matrix_norm(v.mH @ v - eye, 1) / (n * eps)
    return float(rec), float(ou), float(ov)


def labrd_bytes_ms(m, n, itemsize):
    """The bytes bound of ge2bd's two matrix-vector products per column
    (column j: Aᴴ·v on (m − j) × (n − j − 1), A·u on (m − j − 1) ×
    (n − j − 1), each matrix read once), summed over the columns, in ms
    at the card's memory rate."""
    k = min(m, n)
    elems = sum((m - j) * (n - j - 1) + (m - j - 1) * (n - j - 1)
                for j in range(k))
    return elems * itemsize / PEAK_BYTES_PER_S * 1e3


def svd_case(torch, stt, flops, a64, sig, dtype, label, opts, nb, vectors,
             failures, expect=(), forbid=()):
    """svd of ``a64`` rounded to ``dtype`` at ``nb`` under ``opts``: wall
    (host clock ending in a sync), GFLOP/s by flops.svd, each stage's ms,
    σ against the known spectrum (within SVD_VALUE_TOL·σ₁, zeros
    included), with vectors the three gates under SVD_GATE; the stages
    in ``expect`` must have run and those in ``forbid`` not. A failed
    gate is appended to ``failures``."""
    import numpy as np
    m, n = a64.shape
    a = a64.to(dtype)
    A = stt.from_dense(a, nb, device="cuda")
    torch.cuda.synchronize()
    with svd_stage_timer(torch) as stages:
        t0 = time.perf_counter()
        s, U, V = stt.svd(A, opts, want_vectors=vectors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dt = dtype_name(dtype)
    model = flops.svd(max(m, n), min(m, n), vectors)
    row = {"case": label, "m": m, "n": n, "nb": nb, "dtype": dt,
           "method": opts.method_svd.value, "vectors": vectors,
           "wall_s": wall, "gflops": model / wall / 1e9,
           "stages_ms": dict(stages)}
    err = float(np.abs(s.double().cpu().numpy() - sig).max()) / sig[0]
    row["value_err_rel"] = err
    if not err < SVD_VALUE_TOL[dt]:
        failures.append(f"svd {label}: σ {err}·σ₁ off the known spectrum")
    if vectors:
        rec, ou, ov = svd_gates(torch, a, s, U, V)
        row.update(residual=rec, orthogonality_u=ou, orthogonality_v=ov)
        if not max(rec, ou, ov) < SVD_GATE:
            failures.append(f"svd {label}: residual {rec}, orthogonality "
                            f"{ou} / {ov} over {SVD_GATE}")
    ran = set(stages)
    if not (set(expect) <= ran and not set(forbid) & ran):
        failures.append(f"svd {label}: stages {sorted(ran)}, expected "
                        f"{sorted(expect)}, none of {sorted(forbid)}")
    if "ge2bd" in stages:
        # ge2bd's operand: R (kpad²) on the tall arm, else A padded
        kpad = -(-min(m, n) // nb) * nb
        rows = kpad if max(m, n) >= 2 * min(m, n) else \
            -(-max(m, n) // nb) * nb
        row["labrd"] = {
            "columns": kpad,
            "us_per_column": stages["ge2bd"] * 1e3 / kpad,
            "matvec_bytes_bound_ms": labrd_bytes_ms(rows, kpad,
                                                    a.element_size())}
    return row


def svd_phase(torch, stt, ho, seed):
    """svd on the card (see the module docstring, phase 11). Returns
    (row, launches, launches by type); the row's "failures" lists every
    gate that failed."""
    import numpy as np
    from slate_tpu_torch.obs import flops
    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    rng = np.random.default_rng(seed + 11)
    auto = stt.Options()
    dc = stt.Options(method_svd=stt.MethodSVD.DC)
    failures, cases, yard = [], [], {}
    dc_stages = ("ge2bd", "bdsqr", "stedc")
    t_phase = time.perf_counter()
    ho.reset_launches()

    def run(a, sig, dt, label, opts, nb, vectors=True, **kw):
        t = time.perf_counter()
        row = svd_case(torch, stt, flops, a, sig, dt, label, opts, nb,
                       vectors, failures, **kw)
        row["seconds"] = time.perf_counter() - t
        emit("svd_case", **row)
        cases.append(row)

    # (a) the reference's svd row: Auto at 8192 f32 (DC), values and
    # vectors, beside cuSOLVER's svdvals and svd
    a, sig = svd_operator(torch, SVD_N, SVD_N, False, rng)
    for vec in (False, True):
        run(a, sig, f32, "full_" + ("vectors" if vec else "values"), auto,
            SVD_NB, vec, expect=dc_stages, forbid=("hb2td", "ge2tb"))
    a32 = a.to(f32)
    yard["svdvals_8192"] = yardstick_ms(torch, torch.linalg.svdvals, a32)
    yard["svd_8192"] = yardstick_ms(
        torch, lambda x: torch.linalg.svd(x, full_matrices=False), a32)
    del a, a32
    torch.cuda.empty_cache()
    # (b) tall pre-QR: geqrf (K4 at nb = 512), R by DC at 4096
    a, sig = svd_operator(torch, 32768, 4096, False, rng)
    run(a, sig, f32, "tall", auto, 512,
        expect=("geqrf", "unmqr") + dc_stages)
    yard["svdvals_32768x4096"] = yardstick_ms(torch, torch.linalg.svdvals,
                                               a.to(f32))
    del a
    torch.cuda.empty_cache()
    # (c) tall complex under DC: geqrf at nb = 32 (K3's complex128)
    a, sig = svd_operator(torch, 4096, 1024, True, rng)
    run(a, sig, c128, "tall_complex", dc, 32,
        expect=("geqrf", "unmqr") + dc_stages)
    # (d) complex DC: Auto at 2048 in both complex types
    a, sig = svd_operator(torch, 2048, 2048, True, rng)
    for dt in (c64, c128):
        run(a, sig, dt, "dc_complex", auto, 256, expect=dc_stages)
    # (e) the band arm at an uneven n: ge2tb + hb2td + stedc
    a, sig = svd_operator(torch, 1100, 1100, False, rng)
    for vec in (False, True):
        run(a, sig, f64, "band_" + ("vectors" if vec else "values"), auto,
            256, vec, expect=("ge2tb", "hb2td", "stedc"),
            forbid=("ge2bd", "bdsqr"))
    # (f) the dense band arm through the wide transpose
    a, sig = svd_operator(torch, 700, 1000, False, rng)
    run(a, sig, f32, "dense_band_wide", auto, 128, expect=("ge2tb",),
        forbid=("hb2td", "bdsqr", "ge2bd"))
    # (g) rank 1536 of 2048 under DC: the completed σ ≈ 0 columns
    a, sig = svd_operator(torch, 2048, 2048, False, rng, rank=1536)
    run(a, sig, f64, "rank_deficient", dc, 256, expect=dc_stages)
    del a
    torch.cuda.empty_cache()
    launches, types = launch_snapshot(ho)
    for k in ("secular_roots", "trtri_leaves", "qr_panel_base_wide"):
        if not launches[k] > 0:
            failures.append(f"svd launched no {k}")
    if not types["qr_panel_base"].get("complex128", 0) > 0:
        failures.append("svd launched no complex128 qr_panel_base")
    # the labrd chain's device events a column (profiled: not counted)
    a, _ = svd_operator(torch, SVD_CHAIN_N, SVD_CHAIN_N, False, rng)
    A = stt.from_dense(a, 256, device="cuda")
    stt.ge2bd(A)
    events = chain_events(torch, lambda: stt.ge2bd(A))
    row = {"cases": cases, "yardsticks_ms": yard,
           "labrd_column": {"events_per_column_at_1024":
                            events / SVD_CHAIN_N},
           "host_cpus": os.cpu_count(),
           "seconds": time.perf_counter() - t_phase, "failures": failures}
    return row, launches, types


# ---------------------------------------------------------------------------
# phase 12: spectral serving
# ---------------------------------------------------------------------------

# (label, op, (m, n), type, nb): the served operators, seed 0, built as the
# eig and svd phases build theirs
SPECTRAL_OPERATORS = (
    ("eig_float64", "eig", (4096, 4096), "float64", 512),
    ("svd_float64", "svd", (4096, 2048), "float64", 512),
    ("eig_complex128", "eig", (1024, 1024), "complex128", 128),
    ("svd_complex64", "svd", (1024, 512), "complex64", 128),
)
SPECTRAL_REQUESTS = 8       # per catalog function at each width
SPECTRAL_WIDTHS = (1, 16)
SPECTRAL_EXECUTOR = 16      # default solves through an Executor (eig f64)
# a served answer against L·diag(w)·Rᴴ·b in float64 from the resident's own
# tensors: |x − x₆₄|max / (max(m, n)·ε·max|w|·max‖b_j‖₂)
SPECTRAL_SERVED_TOL = 1.0


def spectral_thetas(op, fname, spec, count, rng):
    """``count`` fresh θ for a catalog function: eig solve at midpoints of
    adjacent eigenvalues (off the spectrum); truncate a rank in 1..k, the
    first one a half-integer (rounded half to even); svd solve θ = 0 (the
    pseudoinverse) then ridges in [0, 0.5]; whiten and psd_project θ in
    [0, 0.5]."""
    import numpy as np
    k = spec.size
    if fname == "solve" and op == "eig":
        j = rng.integers(0, k - 1, count)
        return [float(x) for x in (spec[j] + spec[j + 1]) / 2]
    if fname == "truncate":
        r = rng.integers(1, k + 1, count).astype(np.float64)
        r[0] -= 0.5
        return [float(x) for x in r]
    th = [float(x) for x in rng.uniform(0.0, 0.5, count)]
    if fname == "solve":
        th[0] = 0.0
    return th


def spectral_rhs(torch, rows, cols, dtype, rng):
    """A Gaussian (rows, cols) right-hand side of ``dtype`` on the card."""
    b = rng.standard_normal((rows, cols))
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal((rows, cols))
    return torch.as_tensor(b, device="cuda").to(dtype)


def eig_solve_residuals(torch, a64, theta, X, B, eps):
    """Per column ‖(A − θI)·x − b‖∞ / (n·ε·‖A − θI‖∞·‖x‖∞) in float64
    (complex128), ε of the working type."""
    x, b = wide(torch, X), wide(torch, B)
    n = a64.shape[0]
    absd = a64.diagonal().abs()
    anorm = (a64.abs().sum(dim=1) - absd
             + (a64.diagonal() - theta).abs()).max()
    r = (a64 @ x - theta * x - b).abs().max(dim=0).values
    return (r / (n * eps * anorm * x.abs().max(dim=0).values)).tolist()


def spectral_operator_run(torch, stt, ho, sess, label, op, shape, dt, nb,
                          rng, failures):
    """One served operator: registered, its factor timed by stage (CUDA
    events; stedc on the host clock ending in a sync), warmed at 1 and 16
    columns, its spectrum and resident gated, then SPECTRAL_REQUESTS
    requests per catalog function at each width of SPECTRAL_WIDTHS, each
    at a fresh θ: replayed (``solve_matrix``) and eager (the apply
    function on the same resident) timed, the two bit for bit, the
    replayed answer against float64, eig solve's residual. Returns (row,
    the operand in its type, the known spectrum, the handle)."""
    import numpy as np
    from slate_tpu_torch.linalg.eig import chase_hops
    from slate_tpu_torch.runtime.metrics import Histogram
    spectral = stt.spectral
    dtype = getattr(torch, dt)
    cx = dtype.is_complex
    m, n = shape
    if op == "eig":
        a64, spec = eig_operator(torch, n, cx, rng)
        a = a64.to(dtype)
        A = stt.hermitian(torch.tril(a), nb, stt.Uplo.Lower, device="cuda")
        timer = eig_stage_timer(torch)
    else:
        a64, spec = svd_operator(torch, m, n, cx, rng)
        a = a64.to(dtype)
        A = stt.from_dense(a, nb, device="cuda")
        timer = svd_stage_timer(torch)
    del a64
    met = sess.metrics
    h = sess.register(A, op=op)
    row = {"case": label, "op": op, "m": m, "n": n, "nb": nb, "dtype": dt}
    before = dict(ho.LAUNCHES)
    torch.cuda.synchronize()
    with timer as stages:
        t0 = time.perf_counter()
        res = sess.factor(h)
        torch.cuda.synchronize()
        row["factor_wall_s"] = time.perf_counter() - t0
    row["stages_ms"] = dict(stages)
    row["factor_launches"] = {k: ho.LAUNCHES[k] - before[k]
                              for k in ho.LAUNCHES
                              if ho.LAUNCHES[k] - before[k]}
    npad = -(-n // nb) * nb
    s, b = (npad, nb) if op == "eig" else (2 * npad, 2 * nb)
    hops = sum(chase_hops(s, b))
    row["chase"] = {"s": s, "b": b, "hops": hops,
                    "us_per_hop": stages.get("hb2td", math.nan) * 1e3 / hops}
    want = (("he2hb", "hb2td", "stedc", "unmtr_hb2td", "unmtr_he2hb")
            if op == "eig" else ("ge2tb", "hb2td", "stedc", "unmtr_hb2td",
                                 "unmbr_ge2tb"))
    for name in want:
        if name not in stages:
            failures.append(f"spectral {label}: the factor ran no {name} "
                            f"(stages {sorted(stages)})")
    # warmup at 1 and 16 columns: one capture per catalog function at the
    # first (16 columns pad to the same nb-wide key)
    catalog = spectral.function_catalog(op)
    warm = []
    for nrhs in SPECTRAL_WIDTHS:
        c0 = met.get("aot_compiles")
        t0 = time.perf_counter()
        sess.warmup(h, nrhs=nrhs)
        warm.append({"nrhs": nrhs, "wall_s": time.perf_counter() - t0,
                     "captured": met.get("aot_compiles") - c0})
    row["warmup"] = warm
    if not (warm[0]["captured"] == len(catalog) == len(res.graphs)
            and warm[1]["captured"] == 0):
        failures.append(f"spectral {label}: warmup captured {warm}, "
                        f"{len(res.graphs)} graphs for {len(catalog)} "
                        "functions")
    graph_bytes = sum(g.nbytes for g in res.graphs.values())
    row["resident_bytes"] = res.nbytes - graph_bytes
    row["graph_bytes"] = graph_bytes
    # the spectrum and the resident's residual and orthogonality
    rdt = torch.empty((), dtype=dtype).real.dtype
    eps = torch.finfo(rdt).eps
    got = sess.eigvals(h)
    p = res.payload
    if op == "eig":
        ref = np.sort(spec)
        err = float(np.abs(got - ref).max()) / float(np.abs(spec).max())
        order_ok = bool(np.all(np.diff(got) >= 0))
        tol = EIG_VALUE_TOL[dt]
        aw = wide(torch, a)
        v = wide(torch, p.v.dense()[:n, :n])
        lw = wide(torch, p.lam)
        row["residual"] = float(
            torch.linalg.matrix_norm(aw @ v - v * lw[None, :], 1)
            / (n * eps * torch.linalg.matrix_norm(aw, 1)))
        row["orthogonality"] = float(torch.linalg.matrix_norm(
            v.mH @ v - torch.eye(n, dtype=v.dtype, device=v.device), 1)
            / (n * eps))
        gates = (row["residual"], row["orthogonality"])
        del aw, v
    else:
        err = float(np.abs(got - spec).max()) / float(spec[0])
        order_ok = bool(np.all(np.diff(got) <= 0))
        tol = SVD_VALUE_TOL[dt]
        rec, ou, ov = svd_gates(torch, a, p.s, p.u, p.v)
        row.update(residual=rec, orthogonality_u=ou, orthogonality_v=ov)
        gates = (rec, ou, ov)
    row["value_err_rel"] = err
    if not (err < tol and order_ok):
        failures.append(f"spectral {label}: spectrum {err} off (limit "
                        f"{tol}), ordered {order_ok}")
    limit = EIG_GATE if op == "eig" else SVD_GATE
    if not max(gates) < limit:
        failures.append(f"spectral {label}: residual/orthogonality {gates} "
                        f"over {limit}")
    # the requests
    k = got.size
    big = max(m, n)
    a_w = wide(torch, a) if op == "eig" else None
    if op == "eig":
        vw = wide(torch, p.v.dense()[:n, :n])
        bases = {True: (vw, vw), False: (vw, vw)}
    else:
        uw = wide(torch, p.u.dense()[:m, :k])
        vw = wide(torch, p.v.dense()[:n, :k])
        bases = {True: (uw, vw), False: (vw, uw)}
    spec64 = wide(torch, p.lam if op == "eig" else p.s)
    c0, r0 = met.get("aot_compiles"), met.get("graph_replays")
    calls = 0
    timing, served, bits = {}, {}, True
    worst_solve_res = 0.0
    for fname, (wf, forward) in catalog.items():
        rows = n if (op == "eig" or forward) else m
        L64, R64 = bases[forward]
        eager = spectral.make_apply_fn(op, fname)
        worst = 0.0
        for width in SPECTRAL_WIDTHS:
            he, hg = Histogram(), Histogram()
            for theta in spectral_thetas(op, fname, got, SPECTRAL_REQUESTS,
                                         rng):
                bt = spectral_rhs(torch, rows, width, dtype, rng)
                B = stt.from_dense(bt, nb, device="cuda")
                t0 = time.perf_counter()
                X = sess.solve_matrix(h, B, spectral_fn=fname, theta=theta)
                hg.observe(time.perf_counter() - t0)
                calls += 1
                th_t = torch.full((), theta, dtype=rdt, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Xe = eager(p, B, th_t)
                torch.cuda.synchronize()
                he.observe(time.perf_counter() - t0)
                bits = bits and torch.equal(X.dense(), Xe.dense())
                x = X.dense()[:X.shape[0], :width]
                th64 = torch.full((), float(th_t), dtype=torch.float64,
                                  device="cuda")
                w64 = wf(spec64, th64)
                x64 = L64 @ (w64[:, None].to(L64.dtype)
                             * (R64.mH @ wide(torch, bt)))
                scale = (big * eps * float(w64.abs().max())
                         * float(torch.linalg.vector_norm(
                             wide(torch, bt), dim=0).max()))
                worst = max(worst, float((wide(torch, x) - x64).abs().max())
                            / max(scale, 1e-300))
                if op == "eig" and fname == "solve":
                    worst_solve_res = max(worst_solve_res, max(
                        eig_solve_residuals(torch, a_w, float(th_t), x, bt,
                                            eps)))
            timing[f"{fname}_{width}"] = {
                "eager_p50_s": he.percentile(50),
                "eager_p99_s": he.percentile(99),
                "replay_p50_s": hg.percentile(50),
                "replay_p99_s": hg.percentile(99)}
        # the array API on the last right-hand side: the same replay
        xa = sess.apply(h, bt.cpu().numpy(), fn=fname, theta=theta)
        calls += 1
        bits = bits and np.array_equal(xa, x.cpu().numpy())
        served[fname] = worst
    row["apply_timing"] = timing
    row["served_err_units"] = served
    row["served_limit"] = SPECTRAL_SERVED_TOL
    row["replay_equals_eager_bitwise"] = bits
    row["requests"] = calls
    row["new_captures"] = met.get("aot_compiles") - c0
    row["replays"] = met.get("graph_replays") - r0
    if not max(served.values()) <= SPECTRAL_SERVED_TOL:
        failures.append(f"spectral {label}: served answers {served} over "
                        f"{SPECTRAL_SERVED_TOL}")
    if op == "eig":
        row["solve_worst_scaled_residual"] = worst_solve_res
        if not worst_solve_res <= RESIDUAL_BOUND:
            failures.append(f"spectral {label}: solve residual "
                            f"{worst_solve_res} over {RESIDUAL_BOUND}")
    if not bits:
        failures.append(f"spectral {label}: a replayed answer differs from "
                        "the eager apply's bits")
    if not (row["new_captures"] == 0 and row["replays"] == calls):
        failures.append(f"spectral {label}: {row['new_captures']} captures "
                        f"and {row['replays']} replays after warmup for "
                        f"{calls} requests")
    del a_w, vw, bases
    return row, a, spec, h


def spectral_phase(torch, stt, ho, seed, eig_row):
    """The Session's eig and svd operators on the card (see the module
    docstring, phase 12). Returns (row, launches, launches by type); the
    row's "failures" lists every gate that failed."""
    import numpy as np
    from slate_tpu_torch.obs import flops
    rng = np.random.default_rng(seed + 12)
    failures, rows = [], []
    t_phase = time.perf_counter()
    sess = stt.Session(device="cuda")
    met = sess.metrics
    ho.reset_launches()
    kept = {}
    for label, op, shape, dt, nb in SPECTRAL_OPERATORS:
        t = time.perf_counter()
        row, a, spec, h = spectral_operator_run(
            torch, stt, ho, sess, label, op, shape, dt, nb, rng, failures)
        row["seconds"] = time.perf_counter() - t
        emit("spectral_operator", **row)
        rows.append(row)
        if label in ("eig_float64", "svd_float64"):
            kept[label] = (a, spec, h)
        else:
            del a
    # the Executor's default solves on the float64 eig operator
    a, lam, h = kept["eig_float64"]
    n = a.shape[0]
    res = sess.factor(h)
    vw, lw = res.payload.v.dense()[:n, :n], res.payload.lam
    eps = torch.finfo(torch.float64).eps
    bs = [rng.standard_normal(n) for _ in range(SPECTRAL_EXECUTOR)]
    counters0 = dict(met.snapshot()["counters"])
    with stt.Executor(sess, max_batch=SPECTRAL_EXECUTOR,
                      max_wait=2e-3) as ex:
        answers, latency, wall = serve_clients(ex, [(h, b) for b in bs])
    counters = met.snapshot()["counters"]
    delta = {k: v - counters0.get(k, 0) for k, v in counters.items()}
    bad = [x for x in answers if isinstance(x, BaseException)]
    executor = {"submitted": len(bs), "completed": len(bs) - len(bad),
                "wall_s": wall, **{k: delta.get(k, 0) for k in (
                    "completed_requests", "requests_total", "batches_total",
                    "dispatches_total", "graph_replays", "aot_compiles")}}
    if not bad:
        X = torch.as_tensor(np.stack(answers, 1), device="cuda")
        B = torch.as_tensor(np.stack(bs, 1), device="cuda")
        x64 = vw @ ((1.0 / lw)[:, None] * (vw.mH @ B))
        scale = n * eps * float((1.0 / lw).abs().max()) * float(
            torch.linalg.vector_norm(B, dim=0).max())
        executor["served_err_units"] = float((X - x64).abs().max()) / scale
        executor["worst_scaled_residual"] = max(
            eig_solve_residuals(torch, a, 0.0, X, B, eps))
    if not (executor["completed"] == executor["completed_requests"]
            == executor["requests_total"] == len(bs)
            and executor["graph_replays"] == executor["dispatches_total"]
            and executor["aot_compiles"] == 0
            and executor.get("served_err_units", math.inf)
            <= SPECTRAL_SERVED_TOL
            and executor.get("worst_scaled_residual", math.inf)
            <= RESIDUAL_BOUND):
        failures.append(f"spectral executor: {executor}, failed {bad[:2]}")
    launches, types = launch_snapshot(ho)
    for k in ("trtri_leaves", "secular_roots"):
        inside = sum(r["factor_launches"].get(k, 0) for r in rows)
        if not inside > 0:
            failures.append(f"spectral: the factors launched no {k}")
    # beside them (not counted): heev DC at 4096 f64 (the eig phase's row),
    # svd Auto at 4096 × 2048 f64 (one call), eigh and svd (cuSOLVER)
    dc = next(c for c in eig_row["cases"] if c["case"] == "dc_float64")
    a_s, sig, _ = kept["svd_float64"]
    auto = svd_case(torch, stt, flops, a_s, sig, torch.float64,
                    "auto_4096x2048", stt.Options(), 512, True, failures,
                    expect=("geqrf", "unmqr", "ge2bd", "bdsqr"))
    beside = {
        "heev_dc_float64": {"n": dc["n"], "nb": dc["nb"],
                            "wall_s": dc["wall_s"],
                            "stages_ms": dc["stages_ms"]},
        "svd_auto_float64": {k: auto[k] for k in (
            "m", "n", "nb", "wall_s", "stages_ms", "value_err_rel",
            "residual")},
        "yardsticks_ms": {
            "eigh_4096": yardstick_ms(torch, torch.linalg.eigh, a),
            "svd_4096x2048": yardstick_ms(
                torch, lambda x: torch.linalg.svd(x, full_matrices=False),
                a_s)}}
    sess.close()
    del kept, a, a_s, vw, lw, res
    torch.cuda.empty_cache()
    row = {"operators": [r["case"] for r in rows], "executor": executor,
           "beside": beside, "seconds": time.perf_counter() - t_phase,
           "failures": failures}
    return row, rows, launches, types


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "slate_tpu_torch")):
        print("chip_smoke: the slate_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import slate_tpu_torch as stt
    from slate_tpu_torch.core.precision import full_precision
    from slate_tpu_torch.ops import _build, blocked, hopper_ops as ho

    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    log = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: {"seconds": v["seconds"],
                         "ptxas": [ln for ln in v["ptxas"].splitlines()
                                   if "registers" in ln or "spill" in ln]}
                     for k, v in log.items()})
    emit("sass", herk_lower_update=herk_sass_counts(_build))
    emit("spills", complex_instances=complex_spills(_build))

    # the library yardsticks (torch.linalg) run on cuSOLVER
    torch.backends.cuda.preferred_linalg_library("cusolver")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    with full_precision():
        # every plan mode; b = 33 and 200 end in a ragged row block;
        # timed at b = nb and 128 f32, and streaming at 1024 f32 and
        # 512 f64 (the tile of an f64 potrf at nb = 512)
        chol_timed = {(args.nb, torch.float32), (128, torch.float32),
                      (1024, torch.float32), (512, torch.float64)}
        chol_rows = [chol_case(torch, ho, b, dt, gen,
                               timed=(b, dt) in chol_timed)
                     for b, dt in ((1, torch.float32), (33, torch.float32),
                                   (128, torch.float32),
                                   (200, torch.float32),
                                   (512, torch.float32),
                                   (1024, torch.float32),
                                   (512, torch.float64),
                                   (1024, torch.float64))]
        check_chol_modes(chol_rows)
        emit("kernel", name="chol_tile", cases=chol_rows,
             nan_case=chol_nan_case(torch, ho, gen))
        # the main path's tallest base first (timed), a streaming-mode
        # panel (timed), and slabs of a few rows at the ragged end
        lu_rows = [lu_case(torch, ho, hh, w, dt, gen,
                           timed=(hh, w) in ((args.n, 128), (65536, 128)))
                   for hh, w, dt in ((args.n, 128, torch.float32),
                                     (65536, 128, torch.float32),
                                     (8192, 32, torch.float32),
                                     (512, 64, torch.float32),
                                     (1000, 100, torch.float32),
                                     (256, 4, torch.float32),
                                     (4096, 128, torch.float64))]
        lu_rows.append(lu_case(torch, ho, 1024, 64, torch.float32, gen,
                               False, zero_col=10))
        check_plan_modes("lu_panel_base", lu_rows)
        emit("kernel", name="lu_panel_base", cases=lu_rows,
             edge_case=lu_edge_case(torch, ho, gen))
        f32, f64 = torch.float32, torch.float64
        qr_rows = [qr_case(torch, ho, hh, w, dt, gen,
                           timed=(hh, w, dt) in ((2 * args.n, 32, f32),
                                                 (131072, 32, f64)))
                   for hh, w, dt in ((2 * args.n, 32, f32), (8192, 32, f32),
                                     (131072, 32, f64), (1000, 20, f32),
                                     (256, 4, f32), (4096, 32, f64))]
        qr_rows.append(qr_case(torch, ho, 1024, 32, f32, gen, False,
                               zero_col=10))
        check_plan_modes("qr_panel_base", qr_rows)
        emit("kernel", name="qr_panel_base", cases=qr_rows)
        wide_rows = [qr_case(torch, ho, hh, w, dt, gen,
                             timed=(hh, w) == (2 * args.n, 128)
                             or (hh, w, dt) == (32768, 128, f64))
                     for hh, w, dt in ((2 * args.n, 128, f32),
                                       (32768, 128, f64),
                                       (8192, 64, f32), (1000, 96, f32),
                                       (256, 128, f32), (4096, 128, f64))]
        wide_rows.append(qr_case(torch, ho, 1024, 128, f32, gen, False,
                                 zero_col=37))
        check_plan_modes("qr_panel_base_wide", wide_rows)
        emit("kernel", name="qr_panel_base_wide", cases=wide_rows,
             nan_case=qr_nan_case(torch, ho, gen))
        # the widest herk_lower_update of the main path: n/2 at k = n/2
        herk_shapes = [(args.n // 2, args.n // 2, f32)] + [
            x for x in ((8192, 8192, f32), (4096, 4096, f32),
                        (2048, 2048, f32), (1000, 300, f32),
                        (300, 1000, f32), (2048, 1024, f64),
                        (2048, 2048, f64))
            if x[:2] != (args.n // 2, args.n // 2)]
        # timed in full: the widest f32 case and the square f64 one; a
        # 1×TF32 product must fail the entrywise check at 2048² f32
        herk_rows = [herk_case(torch, ho, blocked, hn, hk, dt, gen,
                               timed=(i == 0 or (hn, hk, dt) ==
                                      (2048, 2048, f64)),
                               tf32_probe=(hn, hk, dt) == (2048, 2048, f32))
                     for i, (hn, hk, dt) in enumerate(herk_shapes)]
        # strided views: A's row stride 16-byte aligned (f32, 16-byte
        # copies) and not (f64 at k = 301, one element per copy)
        herk_rows += [herk_case(torch, ho, blocked, hn, hk, dt, gen, False,
                                strided=True)
                      for hn, hk, dt in ((2000, 700, f32), (1000, 301, f64))]
        check(any("tf32x1_entry_ratio_max" in r for r in herk_rows),
              "herk_lower_update: the 1×TF32 probe did not run")
        emit("kernel", name="herk_lower_update", cases=herk_rows,
             nonfinite_cases=[
                 herk_nonfinite_case(torch, ho, gen, dt, v, hk)
                 for dt, v, hk in ((f32, math.nan, 300), (f32, math.inf, 301),
                                   (f64, math.inf, 300))])
        # P1: potri's 256 leaves at n = 16384 first (timed, the kernels
        # line's row); the main path's launches: one 64-row base (B = 1),
        # the leaves of a 128 and a 512 diagonal block as strided views
        # of it (B = 2, 8), in f32 and f64; transposed views of upper
        # leaves (trsm_rec's upper bases), complex128 through a
        # conjugate-transposed view, complex64, ragged s, and zero
        # diagonals at the edges of the 8 × 8 sub-blocks
        c64, c128 = torch.complex64, torch.complex128
        trtri_rows = [
            trtri_case(torch, ho, blocked, nblk, s_, dt, unit, gen,
                       timed=zero is None, view=view, zero_diag=zero)
            for nblk, s_, dt, unit, view, zero in (
                (256, 64, f32, False, None, None),
                (1, 64, f32, False, None, None),
                (2, 64, f32, False, "diag", None),
                (8, 64, f32, False, "diag", None),
                (256, 64, f64, False, None, None),
                (1, 64, f64, False, None, None),
                (2, 64, f64, False, "diag", None),
                (8, 64, f64, False, "diag", None),
                (8, 64, f32, True, "diag", None),
                (8, 64, f64, False, None, None),
                (8, 64, f64, True, None, None),
                (8, 64, f32, False, "t", None),
                (8, 64, f64, True, "t", None),
                (8, 64, c128, False, "conj_t", None),
                (8, 64, c128, True, "conj_t", None),
                (8, 33, c64, False, None, None),
                (4, 64, c64, False, None, None),
                (4, 64, c64, True, "t", None),
                (4, 1, f32, False, None, None), (4, 1, f32, True, None, None),
                (4, 7, f32, False, None, None), (4, 7, f32, True, None, None),
                (4, 33, f32, False, None, None),
                (4, 33, f32, True, None, None),
                (2, 33, f32, False, None, 20), (2, 33, f32, False, None, 0),
                (2, 33, f32, False, None, 7), (2, 33, f32, False, None, 8),
                (2, 33, f64, False, "t", 32), (2, 64, f64, False, None, 0),
                (2, 64, f32, False, "diag", 63))]
        # the batched engine's leaves (timed, appended): the unit leaves
        # of getrs at n = 256 (blocks of a stack) and the leaves at n = 32
        trtri_rows += [trtri_case(torch, ho, blocked, nblk, 32, f32, unit,
                                  gen, timed=True, view=view)
                       for nblk, unit, view in ((1000, True, "batch"),
                                                (10000, False, None))]
        trtri_rows.append(trtri_sweep(torch, ho, blocked, gen))
        emit("kernel", name="trtri_leaves", cases=trtri_rows)
        # P2: the main path's 64-row leaf first (timed), then smaller
        # ones, the failure contracts, in-place views and the sweep
        nopiv_rows = [lu_nopiv_case(torch, ho, s_, dt, gen, timed=True)
                      for s_, dt in ((64, f32), (64, f64), (33, f32),
                                     (7, f64), (1, f32))]
        nopiv_rows += [lu_nopiv_case(torch, ho, 64, dt, gen, zero_at=20)
                       for dt in (f32, f64)]
        nopiv_rows.append(lu_nopiv_case(torch, ho, 64, f32, gen,
                                        nan_at=(5, 3)))
        nopiv_rows += [lu_nopiv_case(torch, ho, 64, dt, gen, view=view,
                                     signed_zeros=True)
                       for dt in (f32, f64) for view in ("strided", "t")]
        nopiv_rows.append(lu_nopiv_sweep(torch, ho, gen))
        emit("kernel", name="lu_nopiv_base", cases=nopiv_rows,
             info_offsets=lu_nopiv_info_offsets(torch, ho, gen))
        # P3: the CALU tournament's round shapes at nb = 512 first (timed,
        # f32 then f64), then one chunk, ragged heights, w < H, and the
        # failure contracts
        batched_rows = [lu_batched_case(torch, ho, bsz, hh, w_, dt, gen,
                                        timed=True)
                        for dt in (f32, f64)
                        for bsz, hh, w_ in ((32, 512, 512), (16, 1024, 512))]
        # the final round's shape, then the resident/streaming boundary
        batched_rows.append(lu_batched_case(torch, ho, 1, 1024, 512, f32,
                                            gen, timed=True))
        batched_rows += [lu_batched_case(torch, ho, bsz, hh, w_, dt, gen,
                                         fault=fault)
                         for bsz, hh, w_, dt, fault in (
                             (1, 1744, 512, f32, None),
                             (1, 1745, 512, f32, None),
                             (1, 1000, 300, f32, None),
                             (3, 777, 129, f64, None),
                             (5, 45, 45, f32, None), (2, 64, 1, f64, None),
                             (8, 512, 512, f32, "zero_column"),
                             (4, 1000, 64, f32, "nan"),
                             (4, 300, 40, f64, "tie"))]
        # the batched engine's panels: (1000, 256, 32), the first of
        # getrf_batched at n = 256, and (10000, 32, 32), its only one at
        # n = 32 (appended: the rows above keep their places)
        batched_rows += [lu_batched_case(torch, ho, bsz, hh, w_, f32, gen,
                                         timed=True)
                         for bsz, hh, w_ in ((1000, 256, 32),
                                             (10000, 32, 32))]
        check_p3_modes(batched_rows)
        emit("kernel", name="lu_panel_batched", cases=batched_rows)
        # P4: the engine's tiles first (timed): the diagonal blocks of a
        # (1000, 256, 256) stack and (10000, 32, 32); then f64, faults,
        # s > 32, and every s from 1 to 64
        p4_rows = [chol_batched_case(torch, ho, bsz, s_, dt, gen,
                                     timed=timed, n_big=n_big,
                                     faults=faults)
                   for bsz, s_, dt, timed, n_big, faults in (
                       (1000, 32, f32, True, 256, ()),
                       (10000, 32, f32, True, None, ()),
                       (1000, 32, f64, True, 256, ()),
                       (1000, 32, f32, False, 256, (0, 20, 31)),
                       (64, 64, f64, False, 128, (0, 20, 63)),
                       (5, 48, f32, False, None, (47,)),
                       (3, 1, f64, False, None, (0,)))]
        p4_rows.append(chol_batched_sweep(torch, ho, gen))
        emit("kernel", name="chol_tile_batched", cases=p4_rows)
        # P5: the engine's panels first (timed): the first of gels at
        # (1000, 512, 256) as a strided view, and (10000, 64, 32); then
        # f64, the streaming plan, ragged shapes and the faults
        p5_rows = [qr_batched_case(torch, ho, bsz, hh, w_, dt, gen,
                                   timed=timed, strided=strided,
                                   fault=fault)
                   for bsz, hh, w_, dt, timed, strided, fault in (
                       (1000, 512, 32, f32, True, True, None),
                       (10000, 64, 32, f32, True, False, None),
                       (1000, 512, 32, f64, True, False, None),
                       (8, 2000, 128, f32, True, False, None),
                       (4, 1000, 128, f64, False, True, None),
                       (5, 7, 7, f32, False, False, None),
                       (3, 100, 1, f64, False, False, None),
                       (16, 256, 32, f32, False, False, "zero_column"),
                       (16, 256, 32, f32, False, True, "nan"),
                       (4, 40, 40, f64, False, False, "nan"))]
        # both sides of every boundary of the plan, f32 and f64
        p5_rows += [qr_batched_case(torch, ho, 6, hh, w_, dt, gen)
                    for hh, w_, dt in p5_boundary_shapes(torch, ho)]
        check({r["plan"]["storage"] for r in p5_rows}
              == {"registers", "shared", "streaming"}
              and {r["plan"]["team"] for r in p5_rows} == {"warp", "cta"},
              "qr_panel_batched: the cases did not cover every plan")
        emit("kernel", name="qr_panel_batched", cases=p5_rows)
        cx_rows = complex_kernel_rows(torch, ho, gen, args.n)
        t_bf16 = time.perf_counter()
        k5_bf16_rows, route_rows = bf16_kernel_rows(torch, ho, gen, args.n,
                                                    args.nb)
        emit("kernel", name="bfloat16", herk_lower_update=k5_bf16_rows,
             routes=route_rows, seconds=time.perf_counter() - t_bf16)
        # P6–P8: the incremental-update kernels
        p6_rows, p7_rows, p8_rows, p6_inv = update_kernel_rows(
            torch, ho, gen, args.n)
        emit("kernel", name="chol_update_sweep", cases=p6_rows,
             invariants=p6_inv)
        emit("kernel", name="qr_append_build", cases=p7_rows)
        emit("kernel", name="qr_append_apply", cases=p8_rows)
        # P9: stedc's secular roots
        import numpy as np
        t_p9 = time.perf_counter()
        p9, p9_rcp = p9_rows(torch, ho, np.random.default_rng(args.seed))
        emit("kernel", name="secular_roots", cases=p9, reciprocal=p9_rcp,
             seconds=time.perf_counter() - t_p9)
        # counted paths: the check phase, then the main phase
        ho.reset_launches()
        small = small_check(torch, stt, gen)
        gels = gels_check(torch, stt, ho, gen)
        gels_cholqr = cholqr_gels_check(torch, stt, ho, gen)
        tsqr = tsqr_check(torch, stt, gen)
        blas3 = blas3_check(torch, stt, gen)
        inverse = inverse_verbs_check(torch, stt, gen)
        calu = calu_check(torch, stt, ho, gen)
        check_launches, check_types = launch_snapshot(ho)
        emit("check", **small, **gels, gels_cholqr=gels_cholqr, tsqr=tsqr,
             blas3=blas3, inverse_and_nopiv=inverse, calu=calu,
             launches=check_launches)
        main = main_path(torch, stt, ho, args.n, args.nb, gen)
        operands = main.pop("operands")
        main_types = {k: dict(v) for k, v in ho.TYPE_LAUNCHES.items()}
        emit("main", **main)
        ho.reset_launches()
        serve = serve_phase(torch, stt, ho, main, operands, args.n, args.nb,
                            args.seed, gen)
        del operands
        serve_launches, serve_types = launch_snapshot(ho)
        emit("serve", **serve, launches=serve_launches)
        ho.reset_launches()
        small = small_phase(torch, stt, ho, gen)
        small_launches, small_types = launch_snapshot(ho)
        emit("small", **small, launches=small_launches)
        ho.reset_launches()
        cx = complex_phase(torch, stt, ho, args.n, args.nb, gen)
        emit("complex", **cx)
        ho.reset_launches()
        cx_small = small_phase(torch, stt, ho, gen, torch.complex64)
        # the complex128 instances of P3, P4 and P5 at the engine's n = 32
        cx_small["verbs"] += [small_verb_run(torch, stt, ho, verb, 32, 10000,
                                             gen, torch.complex128)
                              for verb in ("gesv", "posv", "gels")]
        cx_small_launches, cx_small_types = launch_snapshot(ho)
        emit("complex_small", **cx_small, launches=cx_small_launches,
             launches_by_dtype=cx_small_types)
        torch.cuda.empty_cache()
        ho.reset_launches()
        t_mixed = time.perf_counter()
        mixed = mixed_phase(torch, stt, ho, args.n, args.nb, gen)
        mixed["seconds"] = time.perf_counter() - t_mixed
        mixed_launches, mixed_types = launch_snapshot(ho)
        emit("mixed", **mixed, launches=mixed_launches,
             launches_by_dtype=mixed_types)
        torch.cuda.empty_cache()
        ho.reset_launches()
        upd = update_phase(torch, stt, ho, args.n, args.nb, gen)
        upd_launches, upd_types = launch_snapshot(ho)
        emit("update", **upd, launches=upd_launches,
             launches_by_dtype=upd_types)
        torch.cuda.empty_cache()
        eig, eig_launches, eig_types = eig_phase(torch, stt, ho, args.seed)
        emit("eig", **eig, launches=eig_launches,
             launches_by_dtype=eig_types)
        torch.cuda.empty_cache()
        svd, svd_launches, svd_types = svd_phase(torch, stt, ho, args.seed)
        emit("svd", **svd, launches=svd_launches,
             launches_by_dtype=svd_types)
        torch.cuda.empty_cache()
        spec, _, spec_launches, spec_types = spectral_phase(
            torch, stt, ho, args.seed, eig)
    emit("spectral", **spec, launches=spec_launches,
         launches_by_dtype=spec_types)
    check(not eig["failures"], "; ".join(eig["failures"]))
    check(not svd["failures"], "; ".join(svd["failures"]))
    check(not spec["failures"], "; ".join(spec["failures"]))

    # each kernel's first timed f32 row (K1 at b = nb, the nb = 512
    # factor's tile), and K1 at b = 128 beside it
    k1_128 = next(r for r in chol_rows if r["b"] == 128)
    timed = {name: next(r for r in rows if r.get("ms") is not None
                        and r.get("b", args.nb) == args.nb
                        and r["dtype"] == "float32")
             for name, rows in (("chol_tile", chol_rows),
                                ("lu_panel_base", lu_rows),
                                ("qr_panel_base", qr_rows),
                                ("qr_panel_base_wide", wide_rows),
                                ("herk_lower_update", herk_rows),
                                ("trtri_leaves", trtri_rows),
                                ("lu_nopiv_base", nopiv_rows),
                                ("lu_panel_batched", batched_rows),
                                ("chol_tile_batched", p4_rows),
                                ("qr_panel_batched", p5_rows))}
    kernels = []
    for name, src, rep in (
            ("chol_tile", "chol_tile.cu", "slate_tpu/ops/pallas_ops.py:342"),
            ("lu_panel_base", "lu_panel.cu",
             "slate_tpu/ops/pallas_ops.py:448"),
            ("qr_panel_base", "qr_panel.cu",
             "slate_tpu/ops/pallas_ops.py:688"),
            ("qr_panel_base_wide", "qr_panel.cu",
             "slate_tpu/ops/pallas_ops.py:670"),
            ("herk_lower_update", "herk_lower.cu",
             "slate_tpu/ops/pallas_ops.py:127"),
            # no Pallas kernel: the reference's vmapped and fori_loop leaves
            ("trtri_leaves", "trtri_leaves.cu",
             "slate_tpu/ops/blocked.py:242"),
            ("lu_nopiv_base", "lu_nopiv.cu", "slate_tpu/linalg/lu.py:463"),
            ("lu_panel_batched", "lu_panel_batched.cu",
             "slate_tpu/ops/blocked.py:691"),
            ("chol_tile_batched", "chol_tile_batched.cu",
             "slate_tpu/ops/blocked.py:1072"),
            ("qr_panel_batched", "qr_panel_batched.cu",
             "slate_tpu/ops/blocked.py:1216")):
        row = timed[name]
        launches = (check_launches[name] + main["launches"][name]
                    + serve_launches[name] + small_launches[name]
                    + cx["launches"][name] + cx_small_launches[name]
                    + mixed_launches[name] + upd_launches[name]
                    + eig_launches[name] + svd_launches[name]
                    + spec_launches[name])
        check(launches > 0, f"{name} was not launched on a counted path")
        by_type = {}
        for phase in (check_types, main_types, serve_types, small_types,
                      cx["launches_by_dtype"], cx_small_types, mixed_types,
                      upd_types, eig_types, svd_types, spec_types):
            for dt, k in phase[name].items():
                by_type[dt] = by_type.get(dt, 0) + k
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"slate_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches, "dtypes": sorted(by_type),
            "launches_by_dtype": by_type,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"plan": row["plan"]} if "plan" in row else {}),
            **({"entry_ratio_max": row["entry_ratio_max"]}
               if name == "trtri_leaves" else {}),
            **({k: row[k] for k in ("device_ms", "library_device_ms")}
               if name in ("trtri_leaves", "lu_nopiv_base") else {}),
            **({k: row[k] for k in ("device_ms", "bound_bytes_ms",
                                    "bound_operations_ms")}
               if name in ("lu_panel_batched", "chol_tile_batched",
                           "qr_panel_batched") else {}),
            **({k: row[k] for k in ("library_device_ms", "library_device_by")}
               if name in ("chol_tile_batched", "qr_panel_batched")
               else {})})
    # P3 at the tournament's other round shapes, (16, 1024, 512) f32 and
    # the final round's (1, 1024, 512)
    p3_keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
               "bound_by", "bound_bytes_ms", "bound_operations_ms",
               "library_ms", "plan")
    p3 = kernels[7]
    p3["at_16x1024x512"] = {k: batched_rows[1][k] for k in p3_keys}
    p3["at_1x1024x512"] = {k: batched_rows[4][k] for k in p3_keys}
    # the batched engine's shapes: P3's panels, P1's leaves, P4's tiles and
    # P5's panels beside the rows above
    for r in batched_rows[-2:]:
        p3[f"at_{r['B']}x{r['H']}x{r['w']}"] = {k: r[k] for k in p3_keys}
    for r in trtri_rows[-3:-1]:
        kernels[5][f"at_{r['B']}x{r['s']}x{r['s']}_{r['view'] or 'stack'}"
                   f"_unit{int(r['unit'])}"] = {k: r[k] for k in (
                       "max_abs_err", "ms", "device_ms", "plain_ms",
                       "bound_ms", "bound_by", "library_ms",
                       "library_device_ms")}
    engine_keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                   "bound_by", "bound_bytes_ms", "bound_operations_ms",
                   "library_ms", "library_device_ms", "library_device_by",
                   "plan")
    for kern, rows, shape in ((kernels[8], p4_rows, ("B", "s", "s")),
                              (kernels[9], p5_rows, ("B", "H", "w"))):
        for r in (r for r in rows[1:] if "ms" in r):
            kern["at_" + "x".join(str(r[k]) for k in shape) + "_"
                 + r["dtype"]] = {k: r[k] for k in engine_keys if k in r}
    # the complex instances at the real rows' shapes
    for kern in kernels:
        for key, r in cx_rows.get(kern["name"], {}).items():
            kern[key] = r
    kernels[0]["at_b128"] = {k: k1_128[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "plan")}
    # K5: the FMA bound and the cuBLAS recursion beside the tensor-core
    # bound, and the same numbers at 2048² f64
    k5_f64 = next(r for r in herk_rows if r.get("plain_ms") is not None
                  and r["dtype"] == "float64")
    k5_keys = ("max_abs_err", "entry_ratio_max", "ms", "plain_ms",
               "recursion_ms", "bound_ms", "bound_fma_ms", "bound_by",
               "library_ms", "plan")
    kernels[4].update({k: timed["herk_lower_update"][k] for k in k5_keys})
    kernels[4]["at_f64_2048"] = {k: k5_f64[k] for k in k5_keys}
    # K5's bfloat16 instance at its timed shapes, and the bf16 routes of
    # K1, K2, P1, P3 and P4
    check("bfloat16" in kernels[4]["dtypes"],
          "herk_lower_update: no bfloat16 launch on a counted path")
    for r in (r for r in k5_bf16_rows if "ms" in r):
        kernels[4][f"at_bfloat16_{r['n']}x{r['k']}"] = {k: r[k] for k in (
            "max_abs_err", "tol_ratio_max", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "tflops", "plan")}
    by_name = {kern["name"]: kern for kern in kernels}
    for r in route_rows:
        by_name[r["name"]]["at_bfloat16_route"] = r
        check("bfloat16" in by_name[r["name"]]["dtypes"],
              f"{r['name']}: no bfloat16 launch on a counted path")
    # P6–P8: no Pallas kernel; they replace the reference's update scans.
    # Their launches are the update phase's (its factors', solves' and
    # graphs' launches of the kernels above are in their sums)
    update_keys = ("max_abs_err", "bitwise_equal", "ms", "device_ms",
                   "plain_ms", "bound_ms", "bound_by", "library_ms", "plan")
    for name, src, rep, rows in (
            ("chol_update_sweep", "chol_update.cu",
             "slate_tpu/linalg/update.py:94", p6_rows),
            ("qr_append_build", "qr_append.cu",
             "slate_tpu/linalg/update.py:207", p7_rows),
            ("qr_append_apply", "qr_append.cu",
             "slate_tpu/linalg/update.py:275", p8_rows)):
        row = rows[0]
        by_type = dict(upd_types[name])
        check(upd_launches[name] > 0,
              f"{name} was not launched in the update phase")
        kern = {"name": name, "route": "cuda",
                "source": f"slate_tpu_torch/csrc/{src}", "replaces": rep,
                "launches": upd_launches[name], "dtypes": sorted(by_type),
                "launches_by_dtype": by_type,
                **{k: row[k] for k in update_keys}}
        for r in rows[1:]:
            shape = "x".join(str(r[k]) for k in ("B", "n", "kb", "npad", "P",
                                                 "q") if r.get(k))
            key = f"at_{shape}_{r['dtype']}" + (
                "_down" if r.get("sign") == -1 else "")
            kern[key] = {k: r.get(k) for k in update_keys + (
                "info_max", "bound_chain_ms") if k in r}
        if "bound_chain_ms" in row:
            kern["bound_chain_ms"] = row["bound_chain_ms"]
        kernels.append(kern)
    # P9: no Pallas kernel; it replaces the reference's df32 secular sweep.
    # Its launches are the eig phase's (stedc alone, heev and hegv), the
    # svd phase's and the spectral phase's
    p9_keys = ("max_abs_err", "tolerance", "flipped", "orthogonality", "ms",
               "device_ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "plan", "ns_per_chain_term")
    check(eig_launches["secular_roots"] > 0,
          "secular_roots was not launched in the eig phase")
    kern = {"name": "secular_roots", "route": "cuda",
            "source": "slate_tpu_torch/csrc/secular.cu",
            "replaces": "slate_tpu/linalg/stedc.py:171",
            "launches": sum(ph["secular_roots"] for ph in (
                eig_launches, svd_launches, spec_launches)),
            "dtypes": sorted(set(eig_types["secular_roots"])
                             | set(svd_types["secular_roots"])
                             | set(spec_types["secular_roots"])),
            "launches_by_dtype": {
                dt: sum(ph["secular_roots"].get(dt, 0) for ph in (
                    eig_types, svd_types, spec_types))
                for dt in set(eig_types["secular_roots"])
                | set(svd_types["secular_roots"])
                | set(spec_types["secular_roots"])},
            "k": p9[0]["k"], "spectrum": p9[0]["spectrum"],
            **{k: p9[0][k] for k in p9_keys}}
    for r in p9[1:]:
        kern[f"at_k{r['k']}_{r['spectrum']}"] = {k: r[k] for k in p9_keys}
    kernels.append(kern)
    # the spectral phase's share of P1's and P9's launches, beside their
    # sums over every counted phase
    for kern in kernels:
        if kern["name"] in ("trtri_leaves", "secular_roots"):
            kern["spectral_launches"] = spec_launches[kern["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
