"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``quemb_tpu_torch`` (and nothing of JAX) through octane (C8H18,
STO-3G) BE2-CCSD from the committed RHF fixture, through the
density-fitted long chain C40H82 (STO-3G, nao 282, ``etb:6.0``, naux 3460,
38 BE2 fragments) from integrals and a factor the port builds itself, and
through the rest of the restricted driver (frozen core, IAO+PAO, wide
fragments solved alone, full-basis RDMs, restart, SCI), relaxed densities and
UBE, through the rest of the molecular surface (``be2puffin`` with
QM/MM, autogen and graphgen, ECPs, the scanner, FCIDUMP), through
periodic kBE2 on polyacetylene, and through octane on fragment meshes,
in phases; each prints one line, and any
failure raises (non-zero exit, no ``ok`` line):

0. the device: CUDA name, and ``nvidia-smi`` name and power limit;
1. build the two CUDA kernels of ``quemb_tpu_torch/csrc``, the
   screened-DF transform and the Jacobi eigh (seconds and ``ptxas``
   lines each; a spill fails);
2. kernel against its plain torch version on the card, on every octane
   fragment's screened basis against the octane Cholesky factor, on a
   synthetic case with skipped and partly reachable blocks, and on a
   synthetic factor at C40H82 shapes (a window of 8 of 18 blocks, and the
   same with the ragged tail block); at octane fragment 0 and at the C40
   window, device times of the kernel, the plain version and one library
   call (``torch.matmul`` on the masked basis, TF32 off), warm and with
   the L2 flushed, beside the call's bound;
3. the f32 tier: ``BE(..., int_transform="sparse-DF",
   auxbasis="cholesky")`` under ``QUEMB_TPU_CCSD_F32_ONLY=1``, which must
   launch the kernel once per fragment, then a one-shot CCSD;
4. the f64 route ``BE(mf, fobj)`` and its one-shot CCSD;
5. three objective evaluations (``be_func``) at a seeded potential;
6. density matching on the f64 route at full width: the analytic HF
   Jacobian (``be.get_be_error_jacobian("HF")``), then
   ``be.optimize(solver="CCSD")``, which must reach octane's reference
   E_tot and E_corr within 1e-6 Ha.  The matching loop solves fragments
   from ERIs that are already built, so it launches the kernel 0 times;
   the kernel's count is that of phase 3;
7. the chain's factor and mean field: build the host integral library
   (``g++``), ``DFTensor(mol, "etb:6.0")`` (a 2.2 GB factor), and
   re-converge the DF-RHF on the card from the density of
   ``fixtures/c40_sto3g_dfhf.npz``; the SCF must converge with
   max|FDS - SDF| < 1e-6;
8. the chain's transforms over all 38 fragments: band plan, band gather,
   banded ``SparseDF.transform_all`` against dense
   ``df_transform_batched`` on the same factor and bases
   (max|banded - dense| < 1e-8), then the f32 tier: every fragment's
   kernel output against its plain version at the fragment's real reach,
   38 launches counted, the kernel's device time summed over the 38
   beside the plain version's, ``torch.matmul``'s and the bound;
9. the chain's energies: ``BE(..., int_transform="sparse-DF")`` (f64 tier)
   and ``"int-direct-DF"`` on the same auxiliary basis, HF-in-HF of each
   < 1e-5 Ha, one-shot BE2-CCSD E_corr within 1e-6 Ha of each other; then
   the f32 tier (38 launches, its HF-in-HF and E_corr beside the f64
   values, within the bars below);
10. octane with a frozen core (``fragmentate(..., frozen_core=True)``) on
    the f64 route, CCSD tolerance 1e-6: HF-in-HF < 1e-6 Ha, the HF
    Jacobian, ``optimize`` to E_tot within 1e-6 Ha of the reference's
    -310.3311676424482, ``rdm1_fullbasis`` (tr(rdm1 S) = 50 valence
    electrons within 1e-5), ``compute_energy_full`` in both modes (the
    approximate one within ``np.isclose`` of the same E_tot), and
    ``save`` -> ``from_restart_file`` (``ebe_hf`` equal to 1e-10), with
    the walls;
11. hexene (6-31G, 78 AOs) as ``examples/molbe_hexene_iaos.py`` runs it:
    the port's ``RHF`` (within 1e-8 Ha of the JAX package's
    -234.0731117673), IAO+PAO on STO-3G with a frozen core, one-shot
    BE2-CCSD at tolerance 1e-9: HF-in-HF < 1e-6 Ha, ``E_core`` within
    1e-8 Ha and E_corr within 1e-7 Ha of the JAX package's; the plan must
    make the fragments of nemb 50, 51 and 54, and only those, buckets of
    their own, and the one-shot must count them as ``large``; then those
    three once more, one bucket a fragment and as one bucket padded to
    one shape: E_corr within 1e-8 Ha, walls and peak device memory;
12. H8 BE1 chemical-potential matching with ``solver="SCI"`` within
    1e-6 Ha of ``"FCI"``;
13. octane BE2 on the f64 route with relaxed CCSD densities:
    ``optimize(solver="CCSD", relax_density=True, only_chem=True)`` from
    zero potential (CCSD tolerance 1e-6, as in phase 6) must converge,
    every fragment of the last evaluation must hold the trace identity
    E_elec = tr(h g1) + 0.5 eri : g2 to 1e-8, and E_tot must lie within
    1e-6 Ha of ``OCTANE_RELAXED_ETOT_REF``; then one-shots at CCSD
    tolerance 1e-9 with the closed-shell kernel and with the spin-orbital
    one (``QUEMB_TPU_CCSD_SPINORB=1``): E_corr equal to 1e-8, with both
    walls.  The chemical potential alone is matched because matching every
    potential with relaxed densities takes some 300 evaluations (about 18
    minutes on an H100; ``tools/profile_port.py --parts
    relaxed_matching``);
14. the hexene anion (STO-3G, charge -1, spin 1, nao 42): ``UHF`` at
    ``conv_tol`` 1e-10, then with a frozen core ``UBE`` BE1 and BE2 and
    ``oneshot(solver="UCCSD")``: HF-in-HF < 1e-6 Ha and ebe_tot - ebe_hf
    within 1e-6 Ha of the JAX package's (``HEXENE_ANION_UBE_REF``), with
    the distance from the values recorded in ``tests/test_ube_hexene.py``,
    the walls of the SCF, the constructions and the UCCSD solves, and the
    UCCSD iterations;
15. ``be2puffin`` on octane (STO-3G, BE2, no frozen core) among the four
    MM point charges of ``tests/test_aux_surface.py:328-331``, through the
    port's own QM/MM RHF on the card: HF-in-HF < 1e-6 Ha and E_corr within
    1e-7 Ha of the JAX package's CPU value (``OCTANE_QMMM_ECORR_REF``),
    with the distance to the reference's -0.54879605 from its own chkfile;
    then ``be2puffin(..., unrestricted=True)`` on the hexene anion (BE1,
    frozen core, its own UHF at ``conv_tol`` 1e-12): E_corr within 1e-6 Ha
    of phase 14's BE1;
16. octane BE2 from ``frag_type="autogen"`` matched by ``optimize`` (CCSD
    tolerance 1e-6): E_tot within 1e-6 Ha of -310.3347211309688; then a
    one-shot from ``"graphgen"``: E_corr within 1e-6 Ha of the JAX
    package's (``OCTANE_GRAPHGEN_ECORR_REF``), with its distance from
    chemgen's;
17. propane with the synthetic carbon ECP of ``tests/test_ecp.py``: the
    host ECP quadrature's wall, the RHF on the card and one-shot BE1 and
    BE2 CCSD: HF-in-HF < 1e-6 Ha, E_HF and E_corr within 1e-8 Ha of the
    JAX package's;
18. the H6 BE3-CCSD scanner point within 1e-8 Ha of -3.23567708251885;
    ``FragmentProbe`` against the full scanner, the central-difference
    gradient along the z of octane's first carbon (step 1e-3) within 1e-6;
    ``be2fcidump`` of phase 6's BE in both bases, each file read back
    (``embedding``: within the format's precision of the fragment's Fock
    and ERI; both: the same fragment HF energy within 1e-10 Ha); and the
    timer table of ``BE.initialize``, ``oneshot`` and ``optimize``;
19. periodic kBE2 on polyacetylene (``tests/test_kbe.py:117-129``: STO-3G,
    1x1x3 k-points, nao 24, the default ``KGDF`` aux, naux 1248), nothing
    cut: the ``KGDF`` build (host lattice sums, then the tensors uploaded),
    ``KRHF(conv_tol=1e-11)`` on the card (converged, within 1e-8 Ha of the
    port's CPU value and 2.5e-4 Ha of the fit-free anchor), its
    ``dump_kscf`` -> ``load_kscf(device="cuda")`` (arrays unchanged), then
    with a frozen core chemgen and autogen ``kbe.BE`` (HF-in-HF and
    E_core within 1e-9 / 1e-8 Ha of the port's CPU values) and
    ``optimize(solver="CCSD")``: the matched ``ebe_tot`` within 1e-6 Ha of
    the JAX package's CPU values and 1.5e-3 Ha of the reference
    implementation's; the walls (build, integrals, KRHF, one ``get_jk`` on
    the card, the construction split into localization, Schmidt,
    ``emb_eri`` and fragment SCF, each ``optimize``).  kBE's ERIs come from
    its own GDF, so the screened transform is not on its path;
20. the fragment mesh (``quemb_tpu_torch/parallel/mesh.py``): octane
    BE2 on the f64 route at CCSD tolerance 1e-9, one ``be_func(...,
    eeval=True, return_vec=True)`` at phase 5's seeded potential with no
    mesh and under three meshes: every visible card
    (``make_fragment_mesh()``), two shards on ``cuda:0``, and
    ``(cuda:0, cpu)``, a deliberate check that no operation meets tensors
    of two shards (not a fallback: a one-card machine has no other second
    device); the error norm, the error vector, E_corr and every
    fragment's ``ebe`` within 1e-10 of no mesh, the devices the
    fragments were solved on, and the wall of one evaluation under each
    (median of 3); then ``optimize(solver="CCSD")`` with no mesh and
    under two shards on ``cuda:0``: E_tot within 1e-8 Ha of each other
    and 1e-6 Ha of the reference's -310.3347211309688, with the walls;
    then ``entry.dryrun_multichip(2)`` and ``entry.entry()`` once.

21. the batched Jacobi eigh kernel (``csrc/jacobi_eigh.cu``): the loaded
    function's registers and local (spill) bytes (``cudaFuncGetAttributes``;
    local bytes fail), then at the fragment SCF's shapes on the main path
    (6 x 41 and 6 x 9 for BE2, 1 x 57 and 1 x 9 for BE3), on seeded
    symmetric matrices, the kernel against ``torch.linalg.eigh`` and its
    plain version (eigenvalues and ``||AV - VW||`` within 1e-12
    ``||A||_F``, ``||V^T V - I||`` within 1e-13), and the three timed:
    device ms from CUDA events as in phase 2 (warm) and host wall ms a
    call, with the sweeps each matrix took, beside the kernel's floor
    (:func:`eigh_bound_ms`) and its share of it.

No phase from 10 on reaches the screened-DF kernel (their launch counts
are printed and are 0).  Every phase line carries ``eigh_launches``, the
Jacobi eigh kernel's launches since the line before (the tracer's
``jacobi_eigh.launches`` counter); a phase of :data:`EIGH_PHASES`, each a
float64 fragment SCF of order <= 64 on the card, fails if it reads 0.  The last lines are the kernel report (JSON), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "octane_sto3g_hf.npz")
XYZ = os.path.join(HERE, "tests", "data", "xyz", "octane.xyz")
#: one-shot octane BE2-CCSD correlation energy of the JAX package
#: (BENCH_r05.json ``oneshot_ecorr``, CCSD tolerance 1e-6)
ECORR_REF = -0.5499458109
#: matched octane BE2-CCSD energies of the reference implementation
#: (BASELINE.md; tests/test_molbe_octane.py holds the JAX package to them)
ETOT_MATCHED_REF = -310.3347211309688
ECORR_MATCHED_REF = -0.5499514850769742
MATCHED_TOL = 1e-6  # Ha, on both
#: matched octane BE2-CCSD energy with a frozen core (BASELINE.md;
#: tests/test_molbe_octane.py:test_octane_be2_frozen_core_rdms)
ETOT_FROZEN_CORE_REF = -310.3311676424482
#: hexene (6-31G) through examples/molbe_hexene_iaos.py: the JAX package's
#: RHF at conv_tol 1e-12, E_core and one-shot BE2-CCSD E_corr with IAO+PAO
#: on STO-3G and a frozen core, CCSD tolerance 1e-9 (CPU run)
HEXENE_XYZ = os.path.join(HERE, "tests", "data", "xyz", "hexene.xyz")
HEXENE_EHF_REF = -234.0731117673
HEXENE_ECORE_REF = -292.8440746716
HEXENE_ECORR_REF = -0.6170357576
#: octane BE2-CCSD E_tot with relaxed CCSD densities and the chemical
#: potential matched (f64 route, zero starting potential, HF Jacobian), the
#: JAX package's on the CPU in 3 evaluations
#: (``tools/jax_references.py octane-relaxed``; the port's CPU run of the
#: same gives -310.3351735890543)
OCTANE_RELAXED_ETOT_REF = -310.33517358907795
TRACE_IDENTITY_TOL = 1e-8  # Ha, per fragment of the last evaluation
SPINORB_TOL = 1e-8  # Ha, spin-orbital against closed-shell E_corr
#: hexene anion (STO-3G, charge -1, spin 1) one-shot UBE-UCCSD with a frozen
#: core, ebe_tot - ebe_hf by n_BE: the JAX package's on the CPU
#: (``tools/jax_references.py hexene-anion-ube``), the bar; and the values
#: recorded in tests/test_ube_hexene.py, which the JAX package's BE2 now
#: misses by 1.07e-6 Ha (reported beside the bar, not held)
HEXENE_ANION_UBE_REF = {1: -0.13440830558801053, 2: -0.2295743454301089}
HEXENE_ANION_UBE_RECORDED = {1: -0.13440829, 2: -0.22957541}
#: kernel against plain version, relative to max|plain|: the kernel sums
#: 3xTF32 products (FP32 to about 1e-6 relative), the plain version FP32
#: products, in different orders
KERNEL_REL_TOL = 1e-5
N_TIMINGS = 20  # timings of each version; the median is reported
CALLS_PER_TIMING = 10  # back-to-back calls between two CUDA events
#: device cycles of sleep queued before a timing, so that the host has
#: enqueued every timed call before the first one starts
SLEEP_CYCLES = 2_000_000
FLUSH_BYTES = 256 << 20  # written between cold calls: 5x the 50 MB L2
#: H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: C40H82 / STO-3G at etb 6.0 (BENCH_r05.json ``chain_demo``): naux, nao
#: and the padded nemb; a window of 8 of its 18 blocks is kept, close to
#: the chain's mean reach fraction 0.4539
C40_SHAPE = (3460, 282, 42)
C40_WINDOW = range(5, 13)
C40_TAIL_BLOCK = 17  # AOs 272-281: the ragged last block
#: the real chain: its DF-RHF fixture (hcore, S, C, moe, e_tot, veff; no
#: ERI and no factor), its auxiliary basis and its bars
C40_FIXTURE = os.path.join(HERE, "fixtures", "c40_sto3g_dfhf.npz")
C40_AUX = "etb:6.0"
#: Ha on the SCF's energy step: below one ulp of E_el (-5092 Ha, 9e-13), so
#: the energy must stop to the last bit and the density-change test
#: (10 sqrt(tol) = 1e-6) decides.  The strained model chain converges
#: slowly, and its fragment SCFs amplify what the mean field leaves: at the
#: class default 1e-12 the SCF stops after 134 cycles at max|FDS - SDF|
#: 9e-7 and HF-in-HF is 3.7e-4 Ha on every route; at 1e-14 it takes 715
#: cycles to 1.8e-8 and HF-in-HF is -2.4e-6 Ha.
C40_SCF_TOL = 1e-14
COMMUTATOR_TOL = 1e-6  # max|FDS - SDF| of the converged mean field
BANDED_TOL = 1e-8  # max|banded - dense| over every fragment ERI
HF_IN_HF_TOL = 1e-5  # Ha, the package's own warning level
SPARSE_VS_DENSE_TOL = 1e-6  # Ha, f64 sparse-DF against int-direct-DF
#: f32 tier at C40H82: octane's f32 bars (phase 3).  Its screen is mo_eps
#: 1e-5 per MO, but every fragment's bath reaches all 18 blocks of the
#: chain, so nothing is skipped and what remains is f32 rounding: on the
#: first run on the card its ERIs were 1.5e-7 to 5.8e-7 (relative) from
#: the dense f64 ones and its HF-in-HF equal to the f64 routes' to 5e-8 Ha;
#: its E_corr lies 1e-6 to 1e-5 Ha from the f64 value: the chain's fragment
#: SCFs stop at their cycle cap, and where they stop moves that difference.
C40_F32_HF_TOL = 1e-4
C40_F32_ECORR_TOL = 1e-4
#: CCSD on the chain's f64 routes: its model geometry is strained (HOMO-
#: LUMO gap 0.28 Ha at C8), the amplitudes converge slowly (up to 326
#: iterations to 1e-6, where two routes 3e-11 apart in their ERIs stopped
#: 80 iterations and 3.3e-7 Ha apart), and the default cap of 150 stops
#: short.  So the two routes are compared at 1e-8, with a cap to match.
C40_CCSD_CONV_TOL = "1e-8"
C40_CCSD_MAX_CYCLE = 1000
CHAIN_TIMINGS = 5  # timings of each version per fragment; the median
#: phase 15: the MM point charges and their coordinates (Bohr) of
#: tests/test_aux_surface.py:328-331; one-shot BE2-CCSD E_corr of octane
#: among them through be2puffin (tolerance 1e-9), the JAX package's on the
#: CPU from its own QM/MM RHF (``tools/jax_references.py octane-qmmm``; the
#: port's CPU run gives -0.5487961372728591), the bar at 1e-7; and the
#: reference's value from its own chkfile (BASELINE.md:22), printed
QMMM_CHARGES = [-0.2, -0.1, 0.15, 0.2]
QMMM_COORDS = [(-3, -8, -2), (-2, 6, 1), (2, -5, 2), (1, 8, 1.5)]
OCTANE_QMMM_ECORR_REF = -0.5487961373118537
OCTANE_QMMM_ECORR_CHK = -0.54879605
#: phase 16 (``tools/jax_references.py octane-autogen``, CCSD tolerance
#: 1e-6): the JAX package's matched autogen E_tot on the CPU, printed beside
#: the bar ETOT_MATCHED_REF; and its one-shot graphgen E_corr, the bar.
#: graphgen cuts octane into 8 fragments, chemgen and autogen into 6, so
#: graphgen's E_corr lies 3.6e-4 Ha from chemgen's in both packages; that
#: distance is printed
OCTANE_AUTOGEN_ETOT_JAX = -310.3347214424454
OCTANE_GRAPHGEN_ECORR_REF = -0.5503054291415879
#: phase 17: propane and the synthetic carbon ECP of tests/test_ecp.py, and
#: the JAX package's RHF (conv_tol 1e-12) and one-shot CCSD E_corr by n_BE
#: (tolerance 1e-9) on the CPU (``tools/jax_references.py propane-ecp``)
PROPANE = (
    "C 0 0 0; C 1.26 0.86 0; C 2.52 0 0;"
    "H -0.55 0.94 0; H -0.55 -0.55 0.8; H -0.55 -0.55 -0.8;"
    "H 1.26 1.5 0.88; H 1.26 1.5 -0.88;"
    "H 3.07 0.94 0; H 3.07 -0.55 0.8; H 3.07 -0.55 -0.8"
)
PSEUDO_C = {"C": {"ncore": 2, "local": [(2, 4.5, 8.0), (1, 2.8, 2.0)],
                  "semilocal": {0: [(2, 6.0, 10.0)]}}}
PROPANE_ECP_EHF_REF = -17.237324703430346
PROPANE_ECP_ECORR_REF = {1: -0.1482502562751833, 2: -0.15017364676154443}
#: phase 18: the H6 BE3-CCSD scanner point (BASELINE.md:28), and the
#: fragment probe's FD gradient against the full scanner's along the z of
#: octane's first carbon (tests/test_aux_surface.py:287-313's bar, 1e-6)
H6_SCANNER_REF = -3.23567708251885
PROBE_ATOM = 0
PROBE_STEP = 1e-3
#: write_fcidump leaves out every integral of magnitude up to 1e-12 and
#: writes the rest with 17 significant digits, each unique one once for
#: its eight permutations: a file read back is within 1e-12, plus the
#: ERI's own asymmetry (bounded by 1e-14 of its largest element), of the
#: fragment's arrays
FCIDUMP_DROP = 1e-12
CHAIN_CALLS = 4  # back-to-back calls between two CUDA events
#: phase 19: the polyacetylene cell of tests/test_kbe.py:117-129 (Angstrom;
#: STO-3G, 1x1x3 k-points, the default KGDF aux, omega 0.6)
POLYACETYLENE = """
H      1.4285621630072645    0.0    -0.586173422487319
C      0.3415633681566205    0.0    -0.5879921146011252
H     -1.4285621630072645    0.0     0.586173422487319
C     -0.3415633681566205    0.0     0.5879921146011252
H      1.4285621630072645    0.0     1.868826577512681
C      0.3415633681566205    0.0     1.867007885398875
H     -1.4285621630072645    0.0     3.041173422487319
C     -0.3415633681566205    0.0     3.0429921146011254
"""
POLY_LATTICE = np.diag([8.0, 8.0, 2.455 * 2])
POLY_KMESH = [1, 1, 3]
#: the port's KRHF (conv_tol 1e-11) on the CPU, and with a frozen core the
#: HF-in-HF and E_core of its kbe.BE (``tools/jax_references.py
#: polyacetylene-kbe --package torch``): the card must reproduce them.
#: The JAX package's KRHF stops at its 300-cycle cap unconverged on this
#: cell and its e_tot wanders by ~1e-6 from run to run, so its values are
#: printed beside these, not held; its own Fock build at the port's
#: converged density gives an energy 2.1e-7 Ha from the port's, with
#: max|FDS - SDF| 8.5e-8 (``tools/jax_references.py
#: polyacetylene-krhf-cross``): the rounding its explicit metric
#: pseudo-inverse leaves (kbe/df.py ``KGDF._half_inv``)
POLY_KRHF_REF = -150.07396904706363
POLY_KRHF_TOL = 1e-8
POLY_HF_IN_HF_REF = {"chemgen": -1.750777300912887e-11,
                     "autogen": 1.4580336937797256e-11}
POLY_HF_IN_HF_TOL = 1e-9
POLY_ECORE_REF = -142.19483489608808
POLY_ECORE_TOL = 1e-8
#: the JAX package's values on the CPU (``tools/jax_references.py
#: polyacetylene-kbe``): KRHF e_tot (unconverged at 300 cycles), HF-in-HF
#: and E_core, printed; the matched ebe_tot of chemgen and autogen BE2,
#: held at 1e-6
POLY_KRHF_JAX = -150.07396781308003
POLY_HF_IN_HF_JAX = {"chemgen": 6.797387186452397e-07,
                     "autogen": 6.823846092629537e-07}
POLY_ECORE_JAX = -142.1948349870927
POLY_ETOT_JAX = {"chemgen": -152.19198657970574,
                 "autogen": -152.19533464920124}
POLY_ETOT_TOL = 1e-6
#: the fit-free KRHF anchor (tests/test_kbe.py:137) and the reference
#: implementation's matched energies (tests/test_kbe.py:152, BASELINE.md:25)
POLY_KRHF_EXACT = -150.07420498113717
POLY_KRHF_EXACT_TOL = 2.5e-4
POLY_ETOT_PUBLISHED = {"chemgen": -152.19262755,
                       "autogen": -152.1959745442392}
POLY_ETOT_PUBLISHED_TOL = 1.5e-3
POLY_JK_CALLS = 5  # get_jk calls between two CUDA events


#: phases that run a float64 fragment SCF of order <= 64 on the card: every
#: phase from 3 on but 7 and 8 (the chain's mean field, which is wider, and
#: its transforms), and phase 21
EIGH_PHASES = (3, 4, 5, 6, *range(9, 22))
#: the Jacobi eigh kernel's launches in each phase
EIGH_BY_PHASE: dict[int, int] = {}


def eigh_launches() -> int:
    """Jacobi eigh kernel launches so far in this process (the tracer's
    ``jacobi_eigh.launches`` counter)."""
    from quemb_tpu_torch.utils.profiling import total

    return total("jacobi_eigh.launches")


def phase(n, **facts):
    """Print phase ``n``'s line with the Jacobi eigh kernel's launches
    since the line before; a phase of :data:`EIGH_PHASES` that launched
    it 0 times fails."""
    EIGH_BY_PHASE[n] = eigh_launches() - sum(EIGH_BY_PHASE.values())
    print(json.dumps({"phase": n, **facts,
                      "eigh_launches": EIGH_BY_PHASE[n]}), flush=True)
    if n in EIGH_PHASES and not EIGH_BY_PHASE[n]:
        raise AssertionError(f"phase {n} never launched the Jacobi eigh")


def kernel_launches() -> int:
    """Screened-DF kernel launches so far in this process (the tracer's
    ``screened_df.launches`` counter)."""
    from quemb_tpu_torch.utils.profiling import total

    return total("screened_df.launches")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_ms(fn, calls=CALLS_PER_TIMING, flush=None) -> float:
    """Device milliseconds per call, from CUDA events around ``calls``
    back-to-back calls queued behind a sleep (so the host's enqueue time
    is hidden); ``flush`` is first overwritten to evict the L2."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush is not None:
        flush.add_(1.0)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def call_bound(sd, naux, nao, nemb, reach) -> dict:
    """Bytes and FLOP of one call (the kept columns of B and rows of TA
    read once, the output written once) and the least time the card takes
    for them, at the H100's HBM and FP32 peaks."""
    kept = sum(min(sd.NU_BLOCK, nao - sd.NU_BLOCK * b)
               for b in sd.kept_blocks(reach).tolist())
    rows = naux * nao
    nbytes = 4 * (rows * kept + kept * nemb + rows * nemb)
    flop = 2 * rows * kept * nemb
    t_bytes, t_flop = nbytes / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S
    return dict(bytes=nbytes, flop=flop, bound_ms=1e3 * max(t_bytes, t_flop),
                bound_by="bytes" if t_bytes >= t_flop else "operations")


def time_versions(sd, B, TA, reach, flush) -> dict:
    """Warm and cold device ms of the kernel, the plain version and the
    library call on the same inputs (in turns; medians), with the bound.
    The row mask and the masked basis are built outside the timed
    region."""
    naux, nao, _ = B.shape
    rowmask = sd.block_rowmask(reach, torch.float32, B.device)
    TA_masked = TA * rowmask[:, None]
    Bv = B.view(naux * nao, nao)
    versions = {
        "": lambda: sd.screened_first_transform(B, TA, reach),
        "plain_": lambda: sd.screened_first_transform_plain(B, TA, rowmask),
        "library_": lambda: torch.matmul(Bv, TA_masked),
    }
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for fn in versions.values():  # warm up
            fn()
        times = {f"{k}{w}": [] for k in versions for w in ("ms", "cold_ms")}
        for _ in range(N_TIMINGS):
            for k, fn in versions.items():
                times[f"{k}ms"].append(device_ms(fn))
                times[f"{k}cold_ms"].append(device_ms(fn, 1, flush))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {k: float(np.median(v)) for k, v in times.items()}
    out.update(call_bound(sd, naux, nao, TA.shape[1], reach))
    out["roofline_share_cold"] = out["bound_ms"] / out["cold_ms"]
    out["shape"] = [naux, nao, TA.shape[1], int(sd.kept_blocks(reach).size)]
    return out


def fragment_bases(mf, fobj):
    """Schmidt bases TA of every fragment, built as BE builds them."""
    from quemb_tpu_torch.embed.fragment import Fragment
    from quemb_tpu_torch.lo.lowdin import lowdin_orth

    S = mf.get_ovlp()
    W = lowdin_orth(torch.as_tensor(S, device="cuda")).cpu().numpy()
    lmo = W.T @ S @ mf.mo_coeff
    TAs = []
    for i in range(fobj.n_frag):
        fr = Fragment.from_frag_part(fobj, i)
        fr.sd(W, lmo, mf.mol.nelectron // 2, thr_bath=1.0e-10)
        TAs.append(fr.TA)
    return TAs


def c40_case(sd, device):
    """The synthetic factor at C40 shapes, from a seeded generator on the
    card, a basis, and the reach of the window of kept blocks."""
    naux, nao, nemb = C40_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    B = torch.randn((naux, nao, nao), generator=gen, device=device)
    TA = torch.randn((nao, nemb), generator=gen, device=device)
    reach = np.zeros(nao, bool)
    reach[sd.NU_BLOCK * C40_WINDOW.start:sd.NU_BLOCK * C40_WINDOW.stop] = 1
    return B, TA, reach


def check_kernel(sd, B, TA, reach):
    """Kernel and plain version on the same card inputs; returns max|err|."""
    out = sd.screened_first_transform(B, TA, reach)
    ref = sd.screened_first_transform_plain(
        B, TA, sd.block_rowmask(reach, B.dtype, B.device)
    )
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not (np.isfinite(err) and err <= KERNEL_REL_TOL * scale):
        raise AssertionError(
            f"kernel disagrees: max|err| {err:.3e} > {KERNEL_REL_TOL:g} x "
            f"max|ref| {scale:.3e} (shape {tuple(out.shape)})"
        )
    return err


def wall(fn):
    """(result, seconds) of ``fn()`` with the card drained before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def chain_mean_field(card):
    """Phase 7: the host library, the C40H82 factor and its DF-RHF."""
    from quemb_tpu_torch import native
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF
    from quemb_tpu_torch.utils.geometry import alkane_atoms

    build = native._build()
    native.get_lib()  # loads and validates, or raises
    with np.load(C40_FIXTURE) as d:
        n_c, e_fix = int(d["n_carbons"]), float(d["e_tot"])
        C_fix, veff_fix = d["C"], d["veff"]
        hcore_fix, S_fix = d["hcore"], d["S"]
    mol = Mole(atom=alkane_atoms(n_c), basis="sto-3g")
    mf = RHF(mol, conv_tol=C40_SCF_TOL, max_cycle=1500, with_df=True,
             auxbasis=C40_AUX, device="cuda")
    _, ints_s = wall(lambda: (mf.get_hcore(), mf.get_ovlp()))
    ints_err = max(float(np.abs(mf.get_hcore() - hcore_fix).max()),
                   float(np.abs(mf.get_ovlp() - S_fix).max()))
    if not ints_err < 1e-8:
        raise AssertionError(
            f"one-electron integrals {ints_err:.3e} from the fixture's"
        )
    B, factor_s = wall(mf.get_df_B)
    nocc = mol.nelectron // 2
    dm_fix = 2.0 * C_fix[:, :nocc] @ C_fix[:, :nocc].T
    # the fixture's density under this aux: how far its recorded veff and
    # energy are from this factor's (the fixture does not name its aux)
    veff_dist = float(np.abs(mf.get_veff(dm_fix) - veff_fix).max())
    e_fix_dm = mf.energy_tot(dm_fix)
    e_tot, scf_s = wall(lambda: mf.kernel(dm0=dm_fix))
    S, dm = mf.get_ovlp(), mf.make_rdm1()
    F = mf.get_hcore() + mf.get_veff(dm)
    comm = float(np.abs(F @ dm @ S - S @ dm @ F).max())
    phase(7, native_build_s=build["seconds"], native_cached=build["cached"],
          nao=mol.nao, naux=int(B.shape[0]), one_electron_s=ints_s,
          one_electron_err=ints_err, factor_s=factor_s,
          factor_gb=B.numel() * 8 / 1e9, scf_cycles=mf.cycles,
          scf_converged=mf.converged, scf_s=scf_s, e_tot=e_tot,
          e_tot_minus_fixture=e_tot - e_fix,
          e_of_fixture_density=e_fix_dm,
          e_of_fixture_density_minus_fixture=e_fix_dm - e_fix,
          veff_of_fixture_density_max_dist=veff_dist, commutator=comm,
          card=card)
    if (int(B.shape[0]), mol.nao) != C40_SHAPE[:2]:
        raise AssertionError(f"chain widths: naux {B.shape[0]}, nao {mol.nao}")
    if not mf.converged:
        raise AssertionError(f"DF-RHF not converged in {mf.cycles} cycles")
    if not comm < COMMUTATOR_TOL:
        raise AssertionError(f"max|FDS - SDF| {comm:.3e}")
    return mol, mf


def chain_transforms(sd, mol, mf, fobj, flush, card):
    """Phase 8: every fragment through the f64 banded and dense transforms
    and through the kernel at its real reach.  Returns the kernel's worst
    error and its summed times."""
    from quemb_tpu_torch.ops.df import df_transform_batched
    from quemb_tpu_torch.ops.sparse_df import SparseDF

    cuda = torch.device("cuda")
    B = mf.get_df_B()
    TAs = fragment_bases(mf, fobj)
    nembs = sorted({TA.shape[1] for TA in TAs})
    sdf = SparseDF.from_factor(mol, B, device=cuda)
    perm, col_idx, b, W = sdf._band_plan()
    _, gather_s = wall(sdf._ensure_banded_factor)
    sdf.transform_all(TAs[:2])  # warm the GEMM shapes
    banded, banded_s = wall(lambda: sdf.transform_all(TAs))

    def dense_all():
        out = [None] * len(TAs)
        for nemb in nembs:
            idx = [i for i, TA in enumerate(TAs) if TA.shape[1] == nemb]
            TA_b = torch.as_tensor(np.stack([TAs[i] for i in idx]),
                                   device=cuda)
            for i, e in zip(idx, df_transform_batched(B, TA_b)):
                out[i] = e
        return out

    df_transform_batched(B, torch.as_tensor(np.stack(TAs[:1]), device=cuda))
    dense, dense_s = wall(dense_all)
    band_err = max(float((x - y).abs().max()) for x, y in zip(banded, dense))
    eri_scale = max(float(y.abs().max()) for y in dense)
    if not band_err < BANDED_TOL:
        raise AssertionError(f"max|banded - dense| {band_err:.3e}")
    del banded, sdf
    torch.cuda.empty_cache()

    # f32 tier: the kernel on the real factor at each fragment's reach
    sdf32 = SparseDF.from_factor(mol, B, tier="f32-pallas", device=cuda)
    B32 = sdf32.factor.B32
    naux, nao, _ = B32.shape
    Bv = B32.view(naux * nao, nao)
    kept, kernel_err, kernel_scale = [], 0.0, 0.0
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 cold_ms=0.0, plain_cold_ms=0.0, library_cold_ms=0.0)
    per_fragment = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for TA in TAs:
            TA_eff, reach = sdf32.screen(TA)
            TA32 = torch.as_tensor(TA_eff.astype(np.float32), device=cuda)
            kernel_err = max(kernel_err, check_kernel(sd, B32, TA32, reach))
            rowmask = sd.block_rowmask(reach, torch.float32, cuda)
            TA_masked = TA32 * rowmask[:, None]
            versions = {
                "ms": lambda: sd.screened_first_transform(B32, TA32, reach),
                "plain_ms": lambda: sd.screened_first_transform_plain(
                    B32, TA32, rowmask),
                "library_ms": lambda: torch.matmul(Bv, TA_masked),
            }
            t = {k: float(np.median([device_ms(fn, CHAIN_CALLS)
                                     for _ in range(CHAIN_TIMINGS)]))
                 for k, fn in versions.items()}
            for k, fn in versions.items():
                t[k.replace("ms", "cold_ms")] = float(np.median(
                    [device_ms(fn, 1, flush) for _ in range(CHAIN_TIMINGS)]))
            t["bound_ms"] = call_bound(sd, naux, nao, TA32.shape[1],
                                       reach)["bound_ms"]
            t["kept"] = int(sd.kept_blocks(reach).size)
            for k in total:
                total[k] += t[k]
            kept.append(t["kept"])
            per_fragment.append(t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches0 = kernel_launches()
    eris32, f32_s = wall(lambda: sdf32.transform_all(TAs))
    launches = kernel_launches() - launches0
    if launches != len(TAs):
        raise AssertionError(
            f"{launches} kernel launches for {len(TAs)} fragments"
        )
    f32_rel = [float((x - y).abs().max() / y.abs().max())
               for x, y in zip(eris32, dense)]
    by_kept = {}
    for t in per_fragment:
        by_kept.setdefault(t["kept"], []).append(t)
    by_kept = {
        k: dict(fragments=len(v), **{
            f: float(np.median([t[f] for t in v]))
            for f in ("ms", "cold_ms", "plain_ms", "plain_cold_ms",
                      "library_ms", "library_cold_ms", "bound_ms")
        }) for k, v in sorted(by_kept.items())
    }
    phase(8, n_frag=len(TAs), nemb=nembs, band_W=W, band_b=b,
          band_fraction=sdf32.band_fraction or W / nao,
          band_gather_s=gather_s, banded_s=banded_s, dense_s=dense_s,
          banded_over_dense=banded_s / dense_s, banded_max_abs_err=band_err,
          eri_max_abs=eri_scale, kernel_launches=launches,
          kernel_max_abs_err=kernel_err, tol_rel=KERNEL_REL_TOL,
          kept_blocks_of=-(-nao // sd.NU_BLOCK), kept_min=min(kept),
          kept_mean=float(np.mean(kept)), kept_max=max(kept),
          kernel_sum=total, kernel_share_of_bound=total["bound_ms"]
          / total["ms"], kernel_share_of_bound_cold=total["bound_ms"]
          / total["cold_ms"], kernel_over_library=total["ms"]
          / total["library_ms"], by_kept_blocks=by_kept,
          f32_transform_all_s=f32_s, f32_vs_dense_rel_min=min(f32_rel),
          f32_vs_dense_rel_max=max(f32_rel), timings=CHAIN_TIMINGS,
          calls_per_timing=CHAIN_CALLS, card=card)
    return kernel_err, total


def chain_energies(qt, sd, mf, fobj, card):
    """Phase 9: HF-in-HF and one-shot BE2-CCSD E_corr of the chain through
    the f64 sparse-DF tier, int-direct-DF and the f32 tier.  Returns the
    f32 tier's kernel launches."""
    from quemb_tpu_torch.solvers import rccsd

    cuda = torch.device("cuda")
    out = {}
    iterations = []
    rdiis_inner = rccsd._rdiis_stage

    def counted_rdiis(*args, **kwargs):
        ret = rdiis_inner(*args, **kwargs)
        iterations.append(int(ret[2].max()))
        return ret

    tol_before = os.environ.get("QUEMB_TPU_CCSD_CONV_TOL")
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = C40_CCSD_CONV_TOL
    cap_before, rccsd.MAX_CYCLE = rccsd.MAX_CYCLE, C40_CCSD_MAX_CYCLE
    rccsd._rdiis_stage = counted_rdiis
    try:
        for key, route in (("sparse", "sparse-DF"),
                           ("direct", "int-direct-DF")):
            be, init_s = wall(lambda: qt.BE(mf, fobj, int_transform=route,
                                            auxbasis=C40_AUX, device=cuda))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, solve_s = wall(lambda: be.oneshot("CCSD"))
            stalled = [str(w.message) for w in caught
                       if "not fully converged" in str(w.message)]
            if stalled:
                raise AssertionError(f"{route}: {stalled}")
            out[key] = dict(hf_in_hf=mf.e_tot - be.ebe_hf,
                            ecorr=be.ebe_tot - be.ebe_hf, init_s=init_s,
                            oneshot_s=solve_s,
                            ccsd_iterations_max=max(iterations))
            iterations.clear()
            del be
            torch.cuda.empty_cache()
        os.environ["QUEMB_TPU_CCSD_F32_ONLY"] = "1"
        launches0 = kernel_launches()
        be32, init_s = wall(lambda: qt.BE(
            mf, fobj, int_transform="sparse-DF", auxbasis=C40_AUX,
            device=cuda))
        launches = kernel_launches() - launches0
        _, solve_s = wall(lambda: be32.oneshot("CCSD"))
    finally:
        rccsd._rdiis_stage = rdiis_inner
        os.environ.pop("QUEMB_TPU_CCSD_F32_ONLY", None)
        rccsd.MAX_CYCLE = cap_before
        if tol_before is None:
            del os.environ["QUEMB_TPU_CCSD_CONV_TOL"]
        else:
            os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = tol_before
    out["f32"] = dict(hf_in_hf=mf.e_tot - be32.ebe_hf,
                      ecorr=be32.ebe_tot - be32.ebe_hf, init_s=init_s,
                      oneshot_s=solve_s, kernel_launches=launches,
                      ccsd_iterations_max=max(iterations))
    diff = out["sparse"]["ecorr"] - out["direct"]["ecorr"]
    f32_diff = out["f32"]["ecorr"] - out["sparse"]["ecorr"]
    phase(9, e_hf=mf.e_tot, ccsd_max_cycle=C40_CCSD_MAX_CYCLE,
          ccsd_conv_tol=C40_CCSD_CONV_TOL,
          sparse_minus_direct_ecorr=diff,
          f32_minus_f64_ecorr=f32_diff, n_frag=fobj.n_frag, card=card,
          **{f"{k}_{f}": v for k, d in out.items() for f, v in d.items()})
    for key in ("sparse", "direct"):
        if not abs(out[key]["hf_in_hf"]) < HF_IN_HF_TOL:
            raise AssertionError(
                f"{key} HF-in-HF {out[key]['hf_in_hf']:.3e} Ha"
            )
    if not abs(diff) < SPARSE_VS_DENSE_TOL:
        raise AssertionError(f"sparse-DF - int-direct-DF E_corr {diff:.3e}")
    if launches != fobj.n_frag:
        raise AssertionError(
            f"{launches} kernel launches for {fobj.n_frag} fragments"
        )
    if not abs(out["f32"]["hf_in_hf"]) < C40_F32_HF_TOL:
        raise AssertionError(
            f"f32 tier HF-in-HF {out['f32']['hf_in_hf']:.3e} Ha"
        )
    if not abs(f32_diff) < C40_F32_ECORR_TOL:
        raise AssertionError(f"f32 tier E_corr {f32_diff:.3e} Ha from f64")
    return launches


def octane_frozen_core(qt, sd, mf, fobj, card):
    """Phase 10: octane BE2-CCSD with a frozen core on the f64 route, from
    density matching to the full-basis RDMs, their energy and a restart."""
    import tempfile

    cuda = torch.device("cuda")
    tol_before = os.environ.get("QUEMB_TPU_CCSD_CONV_TOL")
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"  # as in phase 6
    launches0 = kernel_launches()
    try:
        be, init_s = wall(lambda: qt.BE(mf, fobj, device=cuda))
        hf_in_hf = mf.e_tot - be.ebe_hf
        J, jac_s = wall(lambda: be.get_be_error_jacobian("HF"))
        _, opt_s = wall(lambda: be.optimize(solver="CCSD"))
    finally:
        if tol_before is None:
            del os.environ["QUEMB_TPU_CCSD_CONV_TOL"]
        else:
            os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = tol_before
    etot = be.ebe_tot
    (rdm1, rdm2), rdm_s = wall(lambda: be.rdm1_fullbasis(return_ao=True))
    n_val = float(np.trace(rdm1 @ be.S))
    _, full_s = wall(lambda: be.compute_energy_full(approx_cumulant=True,
                                                    return_rdm=False))
    e_full_approx = be.ebe_tot
    be.compute_energy_full(approx_cumulant=False, return_rdm=False)
    e_full_true = be.ebe_tot
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "octane_fc.npz")
        be.save(path)
        be2, restart_s = wall(lambda: qt.BE.from_restart_file(
            mf, fobj, path, device=cuda))
    launches = kernel_launches() - launches0
    phase(10, n_frag=fobj.n_frag, ncore=be.ncore, e_core=be.E_core,
          hf_in_hf=hf_in_hf, init_s=init_s, jacobian_s=jac_s,
          jacobian_shape=list(J.shape), optimize_s=opt_s, etot=etot,
          etot_dev=etot - ETOT_FROZEN_CORE_REF,
          valence_electrons=n_val, rdm2_shape=list(rdm2.shape),
          rdm1_fullbasis_s=rdm_s, compute_energy_full_s=full_s,
          e_full_approx=e_full_approx,
          e_full_approx_dev=e_full_approx - ETOT_FROZEN_CORE_REF,
          e_full_true=e_full_true,
          e_full_true_dev=e_full_true - ETOT_FROZEN_CORE_REF,
          restart_s=restart_s, restart_ebe_hf_diff=be2.ebe_hf - be.ebe_hf,
          kernel_launches=launches, card=card)
    n_expected = mf.mol.nelectron - 2 * be.ncore
    if not abs(hf_in_hf) < 1e-6:
        raise AssertionError(f"frozen-core HF-in-HF {hf_in_hf:.3e} Ha")
    if not abs(etot - ETOT_FROZEN_CORE_REF) < MATCHED_TOL:
        raise AssertionError(
            f"frozen-core matched E_tot {etot:.10f}: |dev| >= {MATCHED_TOL:g}"
        )
    if not abs(n_val - n_expected) < 1e-5:
        raise AssertionError(f"tr(rdm1 S) {n_val:.8f}, not {n_expected}")
    if not np.isclose(e_full_approx, ETOT_FROZEN_CORE_REF):
        raise AssertionError(
            f"compute_energy_full {e_full_approx:.10f} is not close to the"
            " reference"
        )
    if not abs(be2.ebe_hf - be.ebe_hf) < 1e-10:
        raise AssertionError("the restarted BE's ebe_hf differs")
    return launches


def hexene_iao(qt, sd, card):
    """Phase 11: hexene 6-31G from the port's own RHF, IAO+PAO on STO-3G
    with a frozen core, one-shot BE2-CCSD; the plan solves the fragments
    wider than the batched width one to a bucket, and they are then solved
    once more as one bucket, padded to one shape."""
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF
    from quemb_tpu_torch.solvers import dispatch
    from quemb_tpu_torch.utils.profiling import total

    cuda = torch.device("cuda")
    mol = Mole.from_xyz_file(HEXENE_XYZ, basis="6-31g")
    mf = RHF(mol, conv_tol=1e-12, device=cuda)
    e_hf, scf_s = wall(mf.kernel)
    fobj = qt.fragmentate(mol, n_BE=2, frag_type="chemgen",
                          iao_valence_basis="sto-3g", frozen_core=True,
                          print_frags=False)
    tol_before = os.environ.get("QUEMB_TPU_CCSD_CONV_TOL")
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-9"
    launches0 = kernel_launches()
    try:
        be, init_s = wall(lambda: qt.BE(mf, fobj, lo_method="IAO",
                                        device=cuda))
        large0 = total("large")
        _, oneshot_s = wall(lambda: be.oneshot("CCSD"))
        large_lanes = total("large") - large0
        ecorr = be.ebe_tot - be.ebe_hf
        # the fragments the plan solves alone, then once more one bucket a
        # fragment and as one padded bucket, on the same state
        alone = [c for c in dispatch.form_merge_classes(be.fragments)
                 if c[0][0].nao > dispatch._NEMB_BATCHED_MAX]
        wide = [fr for c in alone for fr, _ in c]
        split_nembs = [[fr.nao for fr, _ in c] for c in alone]
        split_pads = [p for c in alone for _, p in c]
        so_t = max(fr.nsocc for fr in wide)
        nv_t = max(fr.nao - fr.nsocc for fr in wide)
        pads = tuple((so_t - fr.nsocc, nv_t - fr.nao + fr.nsocc)
                     for fr in wide)
        paths = {}
        for name, solve in (
            ("alone", lambda: [sum(e) for e in zip(*(
                dispatch._solve_bucket([fr], "CCSD", True, True, False)
                for fr in wide))]),
            ("padded", lambda: dispatch._solve_bucket_batched(
                wide, "CCSD", True, True, False, pads=pads)),
        ):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            e, t = wall(solve)
            paths[name] = dict(ecorr=sum(e), s=t,
                               peak_gb=torch.cuda.max_memory_allocated()
                               / 1e9,
                               peak_over_held_gb=(
                                   torch.cuda.max_memory_allocated()
                                   - base) / 1e9)
    finally:
        if tol_before is None:
            del os.environ["QUEMB_TPU_CCSD_CONV_TOL"]
        else:
            os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = tol_before
    launches = kernel_launches() - launches0
    alone_vs_padded = paths["alone"]["ecorr"] - paths["padded"]["ecorr"]
    phase(11, nao=mol.nao, e_hf=e_hf, e_hf_dev=e_hf - HEXENE_EHF_REF,
          scf_cycles=mf.cycles, scf_s=scf_s, init_s=init_s,
          fragments=[[fr.nao, fr.nsocc] for fr in be.fragments],
          e_core=be.E_core, e_core_dev=be.E_core - HEXENE_ECORE_REF,
          hf_in_hf=mf.e_tot - be.ebe_hf, oneshot_s=oneshot_s, ecorr=ecorr,
          ecorr_dev=ecorr - HEXENE_ECORR_REF,
          large_lanes=large_lanes, alone_nemb=split_nembs,
          wide_pads=pads, wide_paths=paths,
          wide_alone_minus_padded_ecorr=alone_vs_padded,
          kernel_launches=launches, card=card)
    if not abs(e_hf - HEXENE_EHF_REF) < 1e-8:
        raise AssertionError(f"hexene RHF {e_hf:.10f}")
    if not abs(mf.e_tot - be.ebe_hf) < 1e-6:
        raise AssertionError(f"hexene HF-in-HF {mf.e_tot - be.ebe_hf:.3e}")
    if not abs(be.E_core - HEXENE_ECORE_REF) < 1e-8:
        raise AssertionError(f"hexene E_core {be.E_core:.10f}")
    if not abs(ecorr - HEXENE_ECORR_REF) < 1e-7:
        raise AssertionError(f"hexene E_corr {ecorr:.10f}")
    if (sorted(split_nembs) != [[50], [51], [54]]
            or split_pads != [(0, 0)] * 3 or large_lanes != 3):
        raise AssertionError(
            f"solved alone: {split_nembs}, pads {split_pads}, counted"
            f" {large_lanes} large lanes")
    if not abs(alone_vs_padded) < 1e-8:
        raise AssertionError(
            f"alone - padded E_corr {alone_vs_padded:.3e} Ha"
        )
    return launches


def h8_sci(qt, sd, card):
    """Phase 12: H8 BE1 chemical-potential matching with the selected CI
    against FCI (both on the host, the SCF and transforms on the card)."""
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF

    cuda = torch.device("cuda")
    mol = Mole(atom="; ".join(f"H 0 0 {i * 1.0}" for i in range(8)),
               basis="sto-3g")
    mf = RHF(mol, conv_tol=1e-12, device=cuda)
    mf.kernel()
    fobj = qt.fragmentate(mol, n_BE=1, frag_type="chemgen",
                          print_frags=False)
    launches0 = kernel_launches()
    out = {}
    for solver in ("FCI", "SCI"):
        be = qt.BE(mf, fobj, device=cuda)
        _, t = wall(lambda: be.optimize(solver=solver, only_chem=True))
        out[solver] = dict(etot=be.ebe_tot, s=t)
    launches = kernel_launches() - launches0
    diff = out["SCI"]["etot"] - out["FCI"]["etot"]
    phase(12, n_frag=fobj.n_frag, fci=out["FCI"], sci=out["SCI"],
          sci_minus_fci=diff, kernel_launches=launches, card=card)
    if not abs(diff) < 1e-6:
        raise AssertionError(f"SCI - FCI {diff:.3e} Ha")
    return launches


class _env:
    """Environment variables set inside a ``with`` block and restored."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.before = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def octane_relaxed(qt, sd, mf, fobj, etot_phase6, card):
    """Phase 13: octane BE2 chemical-potential matching with relaxed CCSD
    densities (and, for their difference, with unrelaxed ones), the trace
    identity of every fragment's relaxed RDMs, and the spin-orbital CCSD
    kernel against the closed-shell one."""
    from quemb_tpu_torch.matching import beopt
    from quemb_tpu_torch.solvers import dispatch

    cuda = torch.device("cuda")
    relaxed_inner, be_func_inner = dispatch.ccsd_relaxed_rdms, beopt.be_func
    residuals, err_norms = [], []

    def checked_relaxed(h_mo, eri_mo, nsocc):
        rdm1, rdm2, e = relaxed_inner(h_mo, eri_mo, nsocc)
        e_trace = (h_mo * rdm1.T).sum() + 0.5 * (eri_mo * rdm2).sum()
        residuals.append(float(e_trace) - e)
        return rdm1, rdm2, e

    def counted_be_func(*args, **kwargs):
        del residuals[:]  # keep the last evaluation's fragments
        ret = be_func_inner(*args, **kwargs)
        err_norms.append(float(ret[0]))
        return ret

    dispatch.ccsd_relaxed_rdms, beopt.be_func = checked_relaxed, \
        counted_be_func
    launches0 = kernel_launches()
    try:
        with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-6"):  # as in phase 6
            be = qt.BE(mf, fobj, device=cuda)
            _, opt_s = wall(lambda: be.optimize(
                solver="CCSD", relax_density=True, only_chem=True))
    finally:
        dispatch.ccsd_relaxed_rdms, beopt.be_func = relaxed_inner, \
            be_func_inner
    etot = be.ebe_tot
    launches = {"octane_relaxed": kernel_launches() - launches0}
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-6"):
        be = qt.BE(mf, fobj, device=cuda)
        be.optimize(solver="CCSD", only_chem=True)
    etot_unrelaxed = be.ebe_tot
    oneshots = {}
    be = qt.BE(mf, fobj, device=cuda)
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-9"):
        for name, spinorb in (("closed_shell", {}), ("spin_orbital", dict(
                # the port plans no merged buckets under the switch
                QUEMB_TPU_CCSD_SPINORB="1"))):
            launches0 = kernel_launches()
            with _env(**spinorb):
                _, t = wall(lambda: be.oneshot("CCSD"))
            launches[f"octane_{name}_oneshot"] = (kernel_launches()
                                                  - launches0)
            oneshots[name] = dict(ecorr=be.ebe_tot - be.ebe_hf, s=t)
    so_diff = oneshots["spin_orbital"]["ecorr"] - \
        oneshots["closed_shell"]["ecorr"]
    ref_dev = etot - OCTANE_RELAXED_ETOT_REF
    phase(13, n_frag=fobj.n_frag, optimize_s=opt_s,
          evaluations=len(err_norms), final_error_norm=err_norms[-1],
          etot=etot, ecorr=etot - be.ebe_hf, etot_ref_dev=ref_dev,
          relaxed_minus_unrelaxed_etot=etot - etot_unrelaxed,
          relaxed_minus_phase6_etot=etot - etot_phase6,
          trace_identity_residuals=residuals, oneshots=oneshots,
          spin_orbital_minus_closed_shell_ecorr=so_diff,
          kernel_launches=launches, card=card)
    if not err_norms[-1] < 1e-6:
        raise AssertionError(
            f"relaxed matching stopped at error norm {err_norms[-1]:.3e}")
    if len(residuals) != fobj.n_frag or not all(
            abs(r) < TRACE_IDENTITY_TOL for r in residuals):
        raise AssertionError(f"trace identity residuals {residuals}")
    if not abs(ref_dev) < MATCHED_TOL:
        raise AssertionError(f"relaxed E_tot {etot:.10f}: dev {ref_dev}")
    if not abs(so_diff) < SPINORB_TOL:
        raise AssertionError(f"spin-orbital - closed-shell {so_diff:.3e}")
    return launches


def hexene_anion_ube(qt, sd, card):
    """Phase 14: the hexene anion through UHF and one-shot UBE-UCCSD with
    a frozen core, BE1 and BE2."""
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import UHF
    from quemb_tpu_torch.solvers import uccsd
    from quemb_tpu_torch.ube import UBE

    cuda = torch.device("cuda")
    launches0 = kernel_launches()
    mol = Mole.from_xyz_file(HEXENE_XYZ, basis="sto-3g", charge=-1, spin=1)
    mf = UHF(mol, conv_tol=1e-10, device=cuda)
    e_hf, scf_s = wall(mf.kernel)
    update_inner = uccsd.ccsd_update_mat
    calls = []

    def counted_update(*args, **kwargs):
        calls[-1] += 1
        return update_inner(*args, **kwargs)

    out = {}
    uccsd.ccsd_update_mat = counted_update
    try:
        for n_BE, e_ref in HEXENE_ANION_UBE_REF.items():
            fobj = qt.fragmentate(mol, n_BE=n_BE, frag_type="chemgen",
                                  frozen_core=True, print_frags=False)
            ube, init_s = wall(lambda: UBE(mf, fobj, device=cuda))
            calls.append(0)
            _, uccsd_s = wall(lambda: ube.oneshot(solver="UCCSD"))
            ecorr = ube.ebe_tot - ube.ebe_hf
            out[f"be{n_BE}"] = dict(
                n_frag=fobj.n_frag,
                nemb=[[a.nao, b.nao] for a, b in zip(ube.Fobjs_a,
                                                     ube.Fobjs_b)],
                hf_in_hf=ube.hf_etot - ube.ebe_hf, init_s=init_s,
                uccsd_s=uccsd_s, uccsd_iterations=calls[-1], ecorr=ecorr,
                ecorr_dev=ecorr - e_ref,
                ecorr_recorded_dev=ecorr - HEXENE_ANION_UBE_RECORDED[n_BE])
    finally:
        uccsd.ccsd_update_mat = update_inner
    launches = kernel_launches() - launches0
    phase(14, nao=mol.nao, nelec=list(mf.nelec), e_hf=e_hf,
          scf_cycles=mf.cycles, scf_s=scf_s, ube=out,
          kernel_launches=launches, card=card)
    if not mf.converged:
        raise AssertionError("hexene anion UHF did not converge")
    for key, r in out.items():
        if not abs(r["hf_in_hf"]) < 1e-6:
            raise AssertionError(f"{key} HF-in-HF {r['hf_in_hf']:.3e} Ha")
        if not abs(r["ecorr_dev"]) < 1e-6:
            raise AssertionError(f"{key} E_corr {r['ecorr']:.10f}")
    return launches, out["be1"]["ecorr"]


class _captured_be:
    """Every ``BE`` that the port's drivers construct inside a ``with``
    block (``be2puffin`` and the scanner look ``quemb_tpu_torch.BE`` up
    when they are called), in the list the block gets."""

    def __init__(self, qt):
        self.qt = qt

    def __enter__(self):
        made, self.inner = [], self.qt.BE

        class Captured(self.inner):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        self.qt.BE = Captured
        return made

    def __exit__(self, *exc):
        self.qt.BE = self.inner


def qmmm_be2puffin(qt, sd, ube_be1_ecorr, card):
    """Phase 15: one-shot BE2-CCSD of octane in four MM point charges
    through ``be2puffin`` (the port's own QM/MM RHF on the card), then the
    hexene anion's UBE1 through ``be2puffin(unrestricted=True)``."""
    from quemb_tpu_torch.misc import be2puffin

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches0 = kernel_launches()
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-9"), _captured_be(qt) as made:
        ecorr, qmmm_s = wall(lambda: be2puffin(
            XYZ, "sto-3g", n_BE=2, frozen_core=False,
            pts_and_charges=(np.array(QMMM_COORDS, float),
                             np.array(QMMM_CHARGES)), device=cuda))
        be = made[-1]
        ube_ecorr, ube_s = wall(lambda: be2puffin(
            HEXENE_XYZ, "sto-3g", charge=-1, spin=1, unrestricted=True,
            n_BE=1, device=cuda))
    hf_in_hf = be.hf_etot - be.ebe_hf
    launches = kernel_launches() - launches0
    phase(15, phase_s=time.perf_counter() - t_phase,
          e_hf=be.hf_etot, scf_cycles=be.mf.cycles, hf_in_hf=hf_in_hf,
          ecorr=ecorr, ecorr_dev=ecorr - OCTANE_QMMM_ECORR_REF,
          ecorr_reference_chk_dev=ecorr - OCTANE_QMMM_ECORR_CHK,
          be2puffin_s=qmmm_s, ube_ecorr=ube_ecorr,
          ube_ecorr_minus_phase14=ube_ecorr - ube_be1_ecorr,
          ube_be2puffin_s=ube_s, kernel_launches=launches, card=card)
    if not abs(hf_in_hf) < 1e-6:
        raise AssertionError(f"QM/MM HF-in-HF {hf_in_hf:.3e} Ha")
    if not abs(ecorr - OCTANE_QMMM_ECORR_REF) < 1e-7:
        raise AssertionError(f"QM/MM E_corr {ecorr:.10f}")
    if not abs(ube_ecorr - ube_be1_ecorr) < 1e-6:
        raise AssertionError(f"be2puffin UBE1 E_corr {ube_ecorr:.10f}")
    return launches


def fragmenters(qt, sd, mf, card):
    """Phase 16: octane BE2 from autogen, matched (CCSD tolerance 1e-6, as
    phase 6), and one-shot from graphgen."""
    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches0 = kernel_launches()
    mol = mf.mol
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-6"):
        fobj_a = qt.fragmentate(mol, n_BE=2, frag_type="autogen",
                                print_frags=False)
        be, init_s = wall(lambda: qt.BE(mf, fobj_a, device=cuda))
        _, opt_s = wall(lambda: be.optimize(solver="CCSD"))
        etot, hf_a = be.ebe_tot, be.hf_etot - be.ebe_hf
        fobj_g = qt.fragmentate(mol, n_BE=2, frag_type="graphgen",
                                print_frags=False)
        be, ginit_s = wall(lambda: qt.BE(mf, fobj_g, device=cuda))
        _, gshot_s = wall(lambda: be.oneshot("CCSD"))
        ecorr_g, hf_g = be.ebe_tot - be.ebe_hf, be.hf_etot - be.ebe_hf
    launches = kernel_launches() - launches0
    phase(16, phase_s=time.perf_counter() - t_phase,
          autogen_n_frag=fobj_a.n_frag, autogen_hf_in_hf=hf_a,
          autogen_init_s=init_s, autogen_optimize_s=opt_s,
          autogen_etot=etot, autogen_etot_dev=etot - ETOT_MATCHED_REF,
          autogen_etot_jax_dev=etot - OCTANE_AUTOGEN_ETOT_JAX,
          graphgen_n_frag=fobj_g.n_frag, graphgen_hf_in_hf=hf_g,
          graphgen_init_s=ginit_s, graphgen_oneshot_s=gshot_s,
          graphgen_ecorr=ecorr_g,
          graphgen_ecorr_dev=ecorr_g - OCTANE_GRAPHGEN_ECORR_REF,
          graphgen_minus_chemgen_ecorr=ecorr_g - ECORR_REF,
          kernel_launches=launches, card=card)
    for name, hf in (("autogen", hf_a), ("graphgen", hf_g)):
        if not abs(hf) < 1e-6:
            raise AssertionError(f"{name} HF-in-HF {hf:.3e} Ha")
    if not abs(etot - ETOT_MATCHED_REF) < MATCHED_TOL:
        raise AssertionError(f"autogen matched E_tot {etot:.10f}")
    if not abs(ecorr_g - OCTANE_GRAPHGEN_ECORR_REF) < MATCHED_TOL:
        raise AssertionError(f"graphgen one-shot E_corr {ecorr_g:.10f}")
    return launches


def propane_ecp(qt, sd, card):
    """Phase 17: propane with the synthetic carbon ECP of tests/test_ecp.py:
    the host ECP quadrature, the RHF on the card, one-shot BE1 and BE2
    CCSD."""
    from quemb_tpu_torch.chem.ecp import ecp_matrix
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.chem.scf import RHF

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches0 = kernel_launches()
    mol = Mole(atom=PROPANE, basis="sto-3g", ecp=PSEUDO_C)
    t0 = time.perf_counter()
    ecp_matrix(mol)
    ecp_s = time.perf_counter() - t0
    mf = RHF(mol, conv_tol=1e-12, device=cuda)
    e_hf, scf_s = wall(mf.kernel)
    out = {}
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-9"):
        for n_BE, e_ref in PROPANE_ECP_ECORR_REF.items():
            fobj = qt.fragmentate(mol, n_BE=n_BE, print_frags=False)
            be, init_s = wall(lambda: qt.BE(mf, fobj, device=cuda))
            _, shot_s = wall(lambda: be.oneshot("CCSD"))
            ecorr = be.ebe_tot - be.ebe_hf
            out[f"be{n_BE}"] = dict(
                n_frag=fobj.n_frag, hf_in_hf=be.hf_etot - be.ebe_hf,
                ecorr=ecorr, ecorr_dev=ecorr - e_ref, init_s=init_s,
                oneshot_s=shot_s)
    launches = kernel_launches() - launches0
    phase(17, phase_s=time.perf_counter() - t_phase,
          nao=mol.nao, nelectron=mol.nelectron, ecp_matrix_host_s=ecp_s,
          e_hf=e_hf, e_hf_dev=e_hf - PROPANE_ECP_EHF_REF, scf_s=scf_s,
          be=out, kernel_launches=launches, card=card)
    if not (mf.converged and abs(e_hf - PROPANE_ECP_EHF_REF) < 1e-8):
        raise AssertionError(f"propane ECP RHF {e_hf:.12f}")
    for key, r in out.items():
        if not abs(r["hf_in_hf"]) < 1e-6:
            raise AssertionError(f"ECP {key} HF-in-HF {r['hf_in_hf']:.3e}")
        if not abs(r["ecorr_dev"]) < 1e-8:
            raise AssertionError(f"ECP {key} E_corr {r['ecorr']:.12f}")
    return launches


def _fragment_hf_energy(h1, h2, nocc):
    """Closed-shell determinant energy of the lowest ``nocc`` orbitals of
    ``h1`` against ``h2``: the same number in every orthonormal basis of a
    fragment, so a dump in fragment orbitals is checked by it."""
    _, C = np.linalg.eigh(h1)
    D = C[:, :nocc] @ C[:, :nocc].T
    J = np.einsum("pqrs,rs->pq", h2, D)
    K = np.einsum("prqs,rs->pq", h2, D)
    return float(np.einsum("pq,pq->", D, 2.0 * h1 - (2.0 * J - K)))


def scanner_io(qt, sd, be_octane, card):
    """Phase 18: the H6 scanner point, the fragment probe against the full
    scanner at octane, FCIDUMP files of phase 6's BE in both bases read
    back, and the timer table."""
    from quemb_tpu_torch.chem.elements import BOHR2ANG
    from quemb_tpu_torch.chem.mole import Mole
    from quemb_tpu_torch.fragment.chemgen import ChemGenArgs
    from quemb_tpu_torch.scanner import Energy, FragmentProbe
    from quemb_tpu_torch.utils.io import be2fcidump, read_fcidump
    from quemb_tpu_torch.utils.profiling import print_timings
    from quemb_tpu_torch.utils.scratch import WorkDir

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches0 = kernel_launches()
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-9"):
        h6 = Mole(atom="; ".join(f"H 0 0 {i}.0" for i in range(6)),
                  basis="sto-3g")
        e_h6, h6_s = wall(lambda: Energy(
            basis="sto-3g", n_BE=3, solver="CCSD", oneshot=True,
            additional_args=ChemGenArgs(h_treatment="treat_H_like_heavy_atom"),
            device=cuda).as_scanner()(h6))
        mol = Mole.from_xyz_file(XYZ, basis="sto-3g")
        scan = Energy(basis="sto-3g", n_BE=2, solver="CCSD", oneshot=True,
                      device=cuda)
        probe, probe_init_s = wall(lambda: FragmentProbe(mol, scan))
        coords = mol.atom_coords()

        def displaced(dz):
            c = coords.copy()
            c[PROBE_ATOM, 2] += dz
            return Mole(atom=[(e, x * BOHR2ANG)
                              for e, x in zip(mol.elements, c)],
                        basis="sto-3g")

        grads = {}
        for name, fn in (("probe", probe), ("full", scan.as_scanner())):
            (ep, em), s = wall(lambda: (fn(displaced(PROBE_STEP)),
                                        fn(displaced(-PROBE_STEP))))
            grads[name] = dict(grad=(ep - em) / (2 * PROBE_STEP), s=s)
    grad_diff = grads["probe"]["grad"] - grads["full"]["grad"]
    fcidump = {}
    with WorkDir(os.path.join(HERE, "build", "smoke_fcidump")) as wd:
        for basis in ("embedding", "fragment_mo"):
            _, dump_s = wall(lambda: be2fcidump(be_octane, wd / basis,
                                                basis))
            err, e_err, scale, read_s = 0.0, 0.0, 0.0, 0.0
            for i, fr in enumerate(be_octane.fragments):
                t0 = time.perf_counter()
                h1, h2, norb, nelec, _ = read_fcidump(wd / f"{basis}f{i}")
                read_s += time.perf_counter() - t0
                if (norb, nelec) != (fr.TA.shape[1], 2 * fr.nsocc):
                    raise AssertionError(f"{basis} f{i}: {norb}, {nelec}")
                fock, eri = fr.fock, fr.eri.cpu().numpy()
                if basis == "embedding":
                    err = max(err, np.abs(h1 - fock).max(),
                              np.abs(h2 - eri).max())
                    scale = max(scale, np.abs(eri).max())
                e_err = max(e_err, abs(
                    _fragment_hf_energy(h1, h2, fr.nsocc)
                    - _fragment_hf_energy(fock, eri, fr.nsocc)))
            fcidump[basis] = dict(write_s=dump_s, read_s=read_s,
                                  max_abs_err=err,
                                  max_abs_err_bar=FCIDUMP_DROP
                                  + 1e-14 * scale,
                                  fragment_hf_energy_err=e_err)
    launches = kernel_launches() - launches0
    phase(18, phase_s=time.perf_counter() - t_phase,
          h6_etot=e_h6, h6_dev=e_h6 - H6_SCANNER_REF, h6_s=h6_s,
          probe_atom=PROBE_ATOM, probe_step=PROBE_STEP,
          probe_init_s=probe_init_s, gradients=grads,
          probe_minus_full_grad=grad_diff, fcidump=fcidump,
          kernel_launches=launches, card=card)
    print_timings()
    if not abs(e_h6 - H6_SCANNER_REF) < 1e-8:
        raise AssertionError(f"H6 scanner E_tot {e_h6:.12f}")
    if not abs(grad_diff) < 1e-6:
        raise AssertionError(f"probe - full gradient {grad_diff:.3e}")
    for basis, r in fcidump.items():
        if not (r["max_abs_err"] <= r["max_abs_err_bar"]
                and r["fragment_hf_energy_err"] < 1e-10):
            raise AssertionError(f"FCIDUMP {basis}: {r}")
    return launches


class _wall_of:
    """Replaces ``owner.name`` inside a ``with`` block by a wrapper that
    adds the wall of each call (the card drained after it) to ``secs``."""

    def __init__(self, owner, name, secs: list):
        self.owner, self.name, self.secs = owner, name, secs

    def __enter__(self):
        inner = self.inner = getattr(self.owner, self.name)
        self.own = self.name in vars(self.owner)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, timed)

    def __exit__(self, *exc):
        if self.own:
            setattr(self.owner, self.name, self.inner)
        else:  # a method: drop the instance's wrapper
            delattr(self.owner, self.name)


def polyacetylene_kbe(sd, card):
    """Phase 19: periodic kBE2 on polyacetylene at the bold config's full
    size: the KGDF build (host), the KRHF on the card, chemgen and autogen
    BE2 with a frozen core, each matched, and the KRHF through
    dump_kscf -> load_kscf onto the card."""
    import tempfile

    from quemb_tpu_torch import kbe
    from quemb_tpu_torch.kbe import pbe
    from quemb_tpu_torch.matching import beopt
    from quemb_tpu_torch.mf_interfaces import dump_kscf, load_kscf

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches0 = kernel_launches()
    cell = kbe.Cell(atom=POLYACETYLENE, a=POLY_LATTICE, basis="sto-3g")
    kpts = cell.make_kpts(POLY_KMESH)
    gdf, build_s = wall(lambda: kbe.KGDF(cell, kpts, omega=0.6,
                                         device=cuda).build())
    mf = kbe.KRHF(cell, kpts, with_df=gdf, omega=0.6, conv_tol=1e-11,
                  device=cuda)
    _, integrals_s = wall(lambda: (mf.get_ovlp(), mf.get_hcore()))
    e_hf, krhf_s = wall(mf.kernel)
    dm = torch.as_tensor(mf.hf_dm, device=cuda)
    jk_ms = device_ms(lambda: gdf.get_jk(dm), calls=POLY_JK_CALLS)
    del dm
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "krhf.npz")
        dump_kscf(mf, path)
        _, mf2 = load_kscf(path, device="cuda")
    roundtrip = all(np.array_equal(a, b) for a, b in (
        (mf.hf_veff, mf2.hf_veff), (mf.get_ovlp(), mf2.get_ovlp()),
        (mf.get_hcore(), mf2.get_hcore()))) and mf.e_tot == mf2.e_tot \
        and mf2.device == cuda and mf2.with_df.device == cuda
    be_func_inner = beopt.be_func
    for frag_type in ("chemgen", "autogen"):
        fobj = kbe.fragmentate(mol=cell, kpt=POLY_KMESH, n_BE=2,
                               frag_type=frag_type, frozen_core=True,
                               print_frags=False)
        # construction split: Ewald, frozen core and localization (host);
        # then initialize: Schmidt (host), emb_eri and the fragment SCF
        # (card), the rest (the k-averaged projections, fragment energies)
        be, host_s = wall(lambda: kbe.BE(mf, fobj, kpts=kpts, device=cuda,
                                         compute_hf=False))
        split = {"schmidt": [], "emb_eri": [], "fragment_scf": []}
        with _wall_of(pbe, "sd_kpts", split["schmidt"]), \
                _wall_of(gdf, "emb_eri", split["emb_eri"]), \
                _wall_of(pbe, "run_fragment_scf", split["fragment_scf"]):
            _, init_s = wall(be.initialize)
        hf_in_hf = mf.e_tot - (be.ebe_hf + be.ek)
        evals = []

        def counted(*args, **kwargs):
            evals.append(1)
            return be_func_inner(*args, **kwargs)

        beopt.be_func = counted
        try:
            _, opt_s = wall(lambda: be.optimize(solver="CCSD"))
        finally:
            beopt.be_func = be_func_inner
        out[frag_type] = dict(
            n_frag=len(be.fragments), nemb=[fr.nao for fr in be.fragments],
            hf_in_hf=hf_in_hf, e_core=be.E_core, ek=be.ek,
            ebe_hf=be.ebe_hf, ebe_tot=be.ebe_tot,
            localization_host_s=host_s, initialize_s=init_s,
            **{f"{k}_s": sum(v) for k, v in split.items()},
            optimize_s=opt_s, evaluations=len(evals))
        del be
    launches = kernel_launches() - launches0
    for frag_type, r in out.items():
        r.update(hf_in_hf_jax=POLY_HF_IN_HF_JAX[frag_type],
                 e_core_dev=r["e_core"] - POLY_ECORE_REF,
                 e_core_jax_dev=r["e_core"] - POLY_ECORE_JAX,
                 ebe_tot_jax_dev=r["ebe_tot"] - POLY_ETOT_JAX[frag_type],
                 ebe_tot_published_dev=r["ebe_tot"]
                 - POLY_ETOT_PUBLISHED[frag_type])
    phase(19, phase_s=time.perf_counter() - t_phase, nao=cell.nao,
          naux=gdf.naux, nk=len(kpts), kgdf_build_host_s=build_s,
          host_integrals_s=integrals_s, krhf_e_tot=e_hf,
          krhf_dev=e_hf - POLY_KRHF_REF,
          krhf_jax_dev=e_hf - POLY_KRHF_JAX,
          krhf_exact_dev=e_hf - POLY_KRHF_EXACT,
          krhf_converged=mf.converged, krhf_cycles=mf.cycles,
          krhf_s=krhf_s, get_jk_ms=jk_ms, kscf_roundtrip=roundtrip,
          be=out, kernel_launches=launches, card=card)
    if not (mf.converged and abs(e_hf - POLY_KRHF_REF) < POLY_KRHF_TOL
            and abs(e_hf - POLY_KRHF_EXACT) < POLY_KRHF_EXACT_TOL):
        raise AssertionError(f"polyacetylene KRHF {e_hf!r}")
    if not roundtrip:
        raise AssertionError("dump_kscf -> load_kscf changed the KRHF")
    for frag_type, r in out.items():
        if not (abs(r["hf_in_hf"] - POLY_HF_IN_HF_REF[frag_type])
                < POLY_HF_IN_HF_TOL and abs(r["hf_in_hf"]) < HF_IN_HF_TOL
                and abs(r["e_core_dev"]) < POLY_ECORE_TOL):
            raise AssertionError(f"kBE2 {frag_type} construction {r}")
        if not (abs(r["ebe_tot_jax_dev"]) < POLY_ETOT_TOL
                and abs(r["ebe_tot_published_dev"])
                < POLY_ETOT_PUBLISHED_TOL):
            raise AssertionError(f"kBE2 {frag_type} ebe_tot {r['ebe_tot']!r}")
    return launches


#: phase 20: sharded against unsharded, one evaluation (Ha, and on the
#: error vector); matched E_tot under two shards against no mesh (Ha,
#: ``tests/test_mesh.py:62``'s bar)
MESH_TOL = 1e-10
MESH_MATCHED_TOL = 1e-8
MESH_WALLS = 3  # timed evaluations per mesh; the median is reported


def fragment_mesh(qt, sd, mf, fobj, card):
    """Phase 20: octane BE2 sharded over fragment meshes against no mesh,
    ``optimize`` under two shards, and the entry points."""
    from quemb_tpu_torch.entry import dryrun_multichip, entry
    from quemb_tpu_torch.parallel.mesh import make_fragment_mesh, set_mesh
    from quemb_tpu_torch.solvers.dispatch import be_func

    cuda = torch.device("cuda")
    t_phase = time.perf_counter()
    launches0 = kernel_launches()
    be, init_s = wall(lambda: qt.BE(mf, fobj, device=cuda))
    pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3

    def evaluate():
        norm, vec, (ecorr, _) = be_func(pot, be.fragments, be.Nocc, "CCSD",
                                        eeval=True, return_vec=True)
        return dict(norm=float(norm), vec=np.array(vec), ecorr=float(ecorr),
                    ebe=np.array([fr.ebe for fr in be.fragments]),
                    devices=sorted({str(fr.rdm1__.device)
                                    for fr in be.fragments}))

    meshes = {
        "none": None,
        "every_card": make_fragment_mesh(),
        "two_on_cuda0": make_fragment_mesh(["cuda:0", "cuda:0"]),
        # the check that shards never meet, on a one-card machine
        "cuda0_and_cpu": make_fragment_mesh(["cuda:0", "cpu"]),
    }
    runs = {}
    for name, mesh in meshes.items():
        set_mesh(mesh)
        try:
            # the first evaluation under a mesh builds its chunks' stacks
            first, first_s = wall(evaluate)
            walls = [wall(evaluate)[1] for _ in range(MESH_WALLS)]
        finally:
            set_mesh(None)
        runs[name] = dict(first, first_eval_s=first_s,
                          eval_s=float(np.median(walls)), eval_walls_s=walls)
    ref = runs["none"]
    devs = {name: dict(
        norm=abs(r["norm"] - ref["norm"]),
        vec=float(np.abs(r["vec"] - ref["vec"]).max()),
        ecorr=abs(r["ecorr"] - ref["ecorr"]),
        ebe=float(np.abs(r["ebe"] - ref["ebe"]).max()),
    ) for name, r in runs.items() if name != "none"}
    del be
    etot = {}
    opt_s = {}
    for name in ("none", "two_on_cuda0"):
        be = qt.BE(mf, fobj, device=cuda)
        set_mesh(meshes[name])
        try:
            _, opt_s[name] = wall(lambda: be.optimize(solver="CCSD"))
        finally:
            set_mesh(None)
        etot[name] = be.ebe_tot
        del be
    dry, dry_s = wall(lambda: dryrun_multichip(2))
    step, args = entry()
    (t1, t2, e_el, rdm1, delta), entry_s = wall(lambda: step(*args))
    entry_ok = bool(torch.isfinite(e_el).all() and torch.isfinite(t2).all()
                    and float(delta.max()) < 1e-8)
    launches = kernel_launches() - launches0
    phase(20, phase_s=time.perf_counter() - t_phase, n_frag=fobj.n_frag,
          ccsd_conv_tol=os.environ["QUEMB_TPU_CCSD_CONV_TOL"],
          init_s=init_s,
          devices={k: r["devices"] for k, r in runs.items()},
          n_devices={k: len(r["devices"]) for k, r in runs.items()},
          eval_s={k: r["eval_s"] for k, r in runs.items()},
          eval_walls_s={k: r["eval_walls_s"] for k, r in runs.items()},
          first_eval_s={k: r["first_eval_s"] for k, r in runs.items()},
          error_norm=ref["norm"], ecorr=ref["ecorr"],
          dev_from_no_mesh=devs, tol=MESH_TOL,
          cpu_shard="deliberate check that shards never meet; not a"
                    " fallback",
          optimize_etot=etot, optimize_s=opt_s,
          optimize_two_shards_minus_none=etot["two_on_cuda0"]
          - etot["none"],
          optimize_etot_dev=etot["two_on_cuda0"] - ETOT_MATCHED_REF,
          dryrun_multichip=dict(dry, seconds=dry_s),
          entry_e_el=e_el.cpu().tolist(), entry_s=entry_s,
          cuda_device_count=torch.cuda.device_count(),
          kernel_launches=launches, card=card)
    for name, d in devs.items():
        if not all(np.isfinite(v) and v < MESH_TOL for v in d.values()):
            raise AssertionError(f"mesh {name} differs from no mesh: {d}")
    want = {"every_card": {f"cuda:{k}"
                           for k in range(torch.cuda.device_count())},
            "two_on_cuda0": {"cuda:0"},
            "cuda0_and_cpu": {"cuda:0", "cpu"}}
    for name, devices in want.items():
        if set(runs[name]["devices"]) != devices:
            raise AssertionError(
                f"mesh {name} solved on {runs[name]['devices']}")
    if not (abs(etot["two_on_cuda0"] - etot["none"]) < MESH_MATCHED_TOL
            and abs(etot["two_on_cuda0"] - ETOT_MATCHED_REF)
            < MATCHED_TOL):
        raise AssertionError(f"optimize under two shards: {etot}")
    # two shards over the visible cards in turn
    dry_devices = sorted({f"cuda:{k % torch.cuda.device_count()}"
                          for k in range(2)})
    if not (dry["devices"] == dry_devices and np.isfinite(dry["ecorr"])):
        raise AssertionError(f"dryrun_multichip(2): {dry}")
    if not entry_ok:
        raise AssertionError("entry(): non-finite or unconverged step")
    return launches


#: phase 21: (batch, n) of the fragment SCF's eighs on the benchmark's
#: main path (BE2's Fock and DIIS matrices, BE3's), and the bars
EIGH_SHAPES = ((6, 41), (6, 9), (1, 57), (1, 9))
EIGH_TOL = 1e-12  # eigenvalues and residual, relative to ||A||_F
EIGH_ORTH_TOL = 1e-13
EIGH_WALL_CALLS = 50
#: the kernel's floor a step: the bytes an SM's shared memory moves a
#: clock, and one block barrier's latency in clocks (assumed, not
#: measured on the card)
SMEM_BYTES_PER_CLOCK = 128
BARRIER_CYCLES = 24


def sm_clock_mhz() -> float:
    """The card's highest SM clock in MHz (``nvidia-smi``)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])


def eigh_bound_ms(m: int, sweeps: int, clock_mhz: float) -> float:
    """The Jacobi eigh kernel's floor for a matrix of even order ``m`` that
    takes ``sweeps`` sweeps: (m - 1) x sweeps steps that depend on each
    other, each at least its pass over A in shared memory (2 m^2 doubles,
    read and written, at :data:`SMEM_BYTES_PER_CLOCK`) and its two
    barriers, at the highest SM clock.  Matrices of a batch run side by
    side, so a batch's floor is that of its matrix with the most sweeps."""
    step = 2 * m * m * 8 / SMEM_BYTES_PER_CLOCK + 2 * BARRIER_CYCLES
    return (m - 1) * sweeps * step / (clock_mhz * 1e3)


def host_ms(fn, calls=EIGH_WALL_CALLS) -> float:
    """Host wall milliseconds a call over ``calls`` calls, from an idle
    device to the last call's end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def eigh_errors(A, w, V, w_ref) -> dict:
    """Largest eigenvalue difference and residual over ||A||_F, and the
    largest entry of V^T V - I."""
    scale = torch.linalg.matrix_norm(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    res = torch.linalg.matrix_norm(A @ V - V * w[:, None, :])
    return dict(
        eig=float(((w - w_ref).abs().amax(-1) / scale).max()),
        residual=float((res / scale).max()),
        orth=float((V.transpose(1, 2) @ V - eye).abs().max()),
    )


def jacobi_eigh_phase(card):
    """Phase 21: the loaded Jacobi eigh kernel's registers and spills,
    then the kernel against the library and its plain version at the main
    path's shapes, the three timed, beside the kernel's floor."""
    from quemb_tpu_torch.ops import jacobi_eigh as je

    cuda = torch.device("cuda")
    attrs = je.kernel_attributes(cuda)
    if attrs["local_bytes"]:
        raise AssertionError(f"jacobi_eigh uses local memory: {attrs}")
    clock = sm_clock_mhz()
    rng = np.random.default_rng(21)
    shapes = {}
    for nb, n in EIGH_SHAPES:
        X = torch.as_tensor(rng.standard_normal((nb, n, n)), device=cuda)
        A = X + X.transpose(1, 2)
        w, V, sweeps = je.jacobi_eigh(A)
        wp, _, sweeps_p = je.jacobi_eigh_plain(A)
        wl, _ = torch.linalg.eigh(A)
        errs = {"library": eigh_errors(A, w, V, wl),
                "plain": eigh_errors(A, w, V, wp)}
        versions = {"": lambda: je.jacobi_eigh(A),
                    "plain_": lambda: je.jacobi_eigh_plain(A),
                    "library_": lambda: torch.linalg.eigh(A)}
        times = {f"{k}{u}": [] for k in versions for u in ("ms", "wall_ms")}
        for _ in range(5):  # in turns; medians
            for k, fn in versions.items():
                calls = 1 if k == "plain_" else CALLS_PER_TIMING
                times[f"{k}ms"].append(device_ms(fn, calls))
                times[f"{k}wall_ms"].append(
                    host_ms(fn, 2 if k == "plain_" else EIGH_WALL_CALLS))
        m = n + n % 2
        out = {k: float(np.median(v)) for k, v in times.items()}
        out.update(sweeps=sweeps.cpu().tolist(),
                   plain_sweeps=sweeps_p.cpu().tolist(), errors=errs,
                   steps=(m - 1) * int(sweeps.max()),
                   bound_ms=eigh_bound_ms(m, int(sweeps.max()), clock))
        out["us_per_step"] = 1e3 * out["ms"] / max(out["steps"], 1)
        out["bound_share"] = 100.0 * out["bound_ms"] / out["ms"]
        shapes[f"{nb}x{n}"] = out
        for name, e in errs.items():
            if not (e["eig"] <= EIGH_TOL and e["residual"] <= EIGH_TOL
                    and e["orth"] <= EIGH_ORTH_TOL):
                raise AssertionError(
                    f"jacobi_eigh {nb}x{n} against {name}: {e}")
    phase(21, **attrs, sm_clock_mhz=clock, shapes=shapes,
          max_sweeps=je.MAX_SWEEPS, timings=5,
          calls_per_timing=CALLS_PER_TIMING, wall_calls=EIGH_WALL_CALLS,
          card=card)
    return shapes


def main():
    # ---- 0. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import quemb_tpu_torch as qt
    from quemb_tpu_torch.chem.scf import load_fixture
    from quemb_tpu_torch.ops import screened_df as sd
    from quemb_tpu_torch.ops.df import cholesky_df_factor
    from quemb_tpu_torch.ops.sparse_df import SparseDF
    from quemb_tpu_torch.solvers.dispatch import be_func

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase(0, device=kind, nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda)

    # ---- 1. build the kernels
    from quemb_tpu_torch.ops import jacobi_eigh as je

    builds = {"screened_first_transform": sd.build_library(),
              "jacobi_eigh": je.build_library()}
    ptxas = {k: [ln for ln in b["ptxas"] if "Used" in ln or "spill" in ln]
             for k, b in builds.items()}
    spills = [ln for lns in ptxas.values() for ln in lns
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
    phase(1, build_seconds={k: b["seconds"] for k, b in builds.items()},
          cached={k: b["cached"] for k, b in builds.items()}, ptxas=ptxas)
    if spills:
        raise AssertionError(f"a kernel spills registers: {spills}")

    # ---- 2. kernel against the plain version on the card
    cuda = torch.device("cuda")
    mf = load_fixture(FIXTURE, XYZ)
    mol = mf.mol
    fobj = qt.fragmentate(mol, n_BE=2, frag_type="chemgen",
                          print_frags=False)
    B = cholesky_df_factor(mol, tol=1.0e-10, eri=mf.get_eri())
    sdf = SparseDF.from_factor(mol, B, device=cuda)
    B32 = sdf.factor.B32
    max_err = 0.0
    shapes = []
    screened = []
    for TA in fragment_bases(mf, fobj):
        TA_eff, reach = sdf.screen(TA)
        TA32 = torch.as_tensor(TA_eff.astype(np.float32), device=cuda)
        screened.append((TA32, reach))
        max_err = max(max_err, check_kernel(sd, B32, TA32, reach))
        shapes.append([*B32.shape, TA32.shape[1], int(reach.sum())])
    # synthetic: nao 70 (five 16-blocks, the last one ragged), blocks 1
    # and 3 unreachable, block 4 reachable through one AO only
    rng = np.random.default_rng(0)
    nao_s, naux_s, nemb_s = 70, 64, 37
    reach = np.ones(nao_s, bool)
    reach[16:32] = False
    reach[48:70] = False
    reach[66] = True
    Bs = torch.as_tensor(
        rng.standard_normal((naux_s, nao_s, nao_s)).astype(np.float32),
        device=cuda,
    )
    TAs = torch.as_tensor(
        rng.standard_normal((nao_s, nemb_s)).astype(np.float32), device=cuda
    )
    if sd.kept_blocks(reach).tolist() != [0, 2, 4]:
        raise AssertionError("synthetic case: kept blocks are not 0, 2, 4")
    max_err = max(max_err, check_kernel(sd, Bs, TAs, reach))
    # synthetic factor at C40 shapes, from a seeded generator on the card:
    # a window of 8 of 18 blocks, then the same with the ragged tail block
    Bc, TAc, reach_c40 = c40_case(sd, cuda)
    reach_tail = reach_c40.copy()
    reach_tail[sd.NU_BLOCK * C40_TAIL_BLOCK + 3] = True
    if sd.kept_blocks(reach_tail).tolist() != [*C40_WINDOW, C40_TAIL_BLOCK]:
        raise AssertionError("C40 case: kept blocks are not the window + 17")
    c40_err = max(check_kernel(sd, Bc, TAc, r) for r in (reach_c40,
                                                          reach_tail))
    # device times at octane fragment 0 and at the C40 window
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=cuda)
    flush.zero_()
    TA32, reach = screened[0]
    timed = {
        "octane_frag0": time_versions(sd, B32, TA32, reach, flush),
        "c40_8of18": time_versions(sd, Bc, TAc, reach_c40, flush),
    }
    phase(2, octane_shapes=shapes, synthetic=[naux_s, nao_s, nao_s, nemb_s],
          c40=[*Bc.shape, TAc.shape[1]], max_abs_err=max_err,
          c40_max_abs_err=c40_err, tol_rel=KERNEL_REL_TOL, timed=timed,
          timings=N_TIMINGS, calls_per_timing=CALLS_PER_TIMING, card=card)
    max_err = max(max_err, c40_err)
    del sdf, B32, Bs, TAs, screened, Bc, TAc, flush
    torch.cuda.empty_cache()

    # ---- 3. main path, f32 tier: the kernel runs once per fragment
    os.environ["QUEMB_TPU_CCSD_F32_ONLY"] = "1"
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    be32 = qt.BE(mf, fobj, int_transform="sparse-DF", auxbasis="cholesky",
                 device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = kernel_launches() - launches0
    if launches != fobj.n_frag:
        raise AssertionError(
            f"{launches} kernel launches for {fobj.n_frag} fragments"
        )
    hf32 = be32.ebe_hf - mf.e_tot
    if not abs(hf32) < 1e-4:
        raise AssertionError(f"f32 tier HF-in-HF {hf32:.3e} >= 1e-4 Ha")
    t0 = time.perf_counter()
    be32.oneshot("CCSD")
    oneshot32_s = time.perf_counter() - t0
    ecorr32 = be32.ebe_tot - be32.ebe_hf
    if not abs(ecorr32 - ECORR_REF) < 1e-4:
        raise AssertionError(
            f"f32 tier E_corr {ecorr32:.10f}: |dev| >= 1e-4 Ha"
        )
    phase(3, kernel_launches=launches, n_frag=fobj.n_frag,
          hf_in_hf=hf32, ecorr=ecorr32, ecorr_dev=ecorr32 - ECORR_REF,
          init_s=init_s, oneshot_s=oneshot32_s, card=card)
    del os.environ["QUEMB_TPU_CCSD_F32_ONLY"]
    del be32

    # ---- 4. main path, f64 route (Cholesky-factor transform on CUDA)
    os.environ["QUEMB_TPU_CCSD_CONV_TOL"] = "1e-6"
    t0 = time.perf_counter()
    be = qt.BE(mf, fobj, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    hf64 = be.ebe_hf - mf.e_tot
    if not abs(hf64) < 1e-6:
        raise AssertionError(f"f64 HF-in-HF {hf64:.3e} >= 1e-6 Ha")
    t0 = time.perf_counter()
    be.oneshot("CCSD")
    oneshot_s = time.perf_counter() - t0
    ecorr = be.ebe_tot - be.ebe_hf
    if not abs(ecorr - ECORR_REF) < 1e-6:
        raise AssertionError(f"f64 E_corr {ecorr:.10f}: |dev| >= 1e-6 Ha")
    phase(4, hf_in_hf=hf64, ecorr=ecorr, ecorr_dev=ecorr - ECORR_REF,
          init_s=init_s, oneshot_s=oneshot_s, card=card)

    # ---- 5. objective evaluations at a seeded matching potential
    pot = np.random.default_rng(0).standard_normal(len(be.pot)) * 1e-3
    walls = []
    for eeval in (True, True, False):
        t0 = time.perf_counter()
        ret = be_func(pot, be.fragments, be.Nocc, "CCSD", eeval=eeval,
                      return_vec=True)
        walls.append(time.perf_counter() - t0)
        ervec = ret[1]
        if not (ervec.shape == (len(pot),) and np.all(np.isfinite(ervec))):
            raise AssertionError("objective error vector is not finite")
        if eeval and not np.isfinite(ret[2][0]):
            raise AssertionError("objective energy is not finite")
    phase(5, first_eeval_s=walls[0], warm_eeval_s=walls[1],
          warm_error_only_s=walls[2], error_norm=float(ret[0]), card=card)

    # ---- 6. density matching on the f64 route, from zero potential
    from quemb_tpu_torch.matching import beopt

    for fr in be.fragments:  # phase 5 left its seeded potential in heff
        fr.update_heff(be.pot)
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    J0 = be.get_be_error_jacobian("HF")
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    if not (J0.shape == (len(be.pot),) * 2 and np.all(np.isfinite(J0))):
        raise AssertionError(
            f"Jacobian {J0.shape} for {len(be.pot)} potentials, or not"
            " finite"
        )
    # count what optimize does: objective evaluations with their error
    # norms, and quasi-Newton steps
    err_norms, qn_steps = [], []
    be_func_inner, next_step_inner = beopt.be_func, beopt.FrankQN.next_step

    def counted_be_func(*args, **kwargs):
        ret = be_func_inner(*args, **kwargs)
        err_norms.append(float(ret[0]))
        return ret

    def counted_next_step(self, it, **kwargs):
        qn_steps.append(it)
        return next_step_inner(self, it, **kwargs)

    beopt.be_func, beopt.FrankQN.next_step = counted_be_func, \
        counted_next_step
    try:
        t0 = time.perf_counter()
        be.optimize(solver="CCSD", only_chem=False)
        torch.cuda.synchronize()
        optimize_s = time.perf_counter() - t0
    finally:
        beopt.be_func, beopt.FrankQN.next_step = be_func_inner, \
            next_step_inner
    ecorr_m = be.ebe_tot - be.ebe_hf
    etot_matched = be.ebe_tot
    phase(6, jacobian_s=jac_s, jacobian_shape=list(J0.shape),
          evaluations=len(err_norms), qn_iterations=len(qn_steps),
          first_error_norm=err_norms[0], final_error_norm=err_norms[-1],
          optimize_s=optimize_s, etot=be.ebe_tot,
          etot_dev=be.ebe_tot - ETOT_MATCHED_REF, ecorr=ecorr_m,
          ecorr_dev=ecorr_m - ECORR_MATCHED_REF,
          ccsd_conv_tol=os.environ["QUEMB_TPU_CCSD_CONV_TOL"],
          kernel_launches=kernel_launches() - launches0, card=card)
    if not err_norms[-1] < 1e-6:
        raise AssertionError(
            f"matching stopped at error norm {err_norms[-1]:.3e} >= 1e-6"
        )
    if not abs(be.ebe_tot - ETOT_MATCHED_REF) < MATCHED_TOL:
        raise AssertionError(
            f"matched E_tot {be.ebe_tot:.10f}: |dev| >= {MATCHED_TOL:g} Ha"
        )
    if not abs(ecorr_m - ECORR_MATCHED_REF) < MATCHED_TOL:
        raise AssertionError(
            f"matched E_corr {ecorr_m:.10f}: |dev| >= {MATCHED_TOL:g} Ha"
        )

    be6 = be  # phase 18 writes its FCIDUMP files
    del be
    torch.cuda.empty_cache()

    # ---- 7-9. the density-fitted chain, C40H82
    mol40, mf40 = chain_mean_field(card)
    fobj40 = qt.fragmentate(mol40, n_BE=2, frag_type="chemgen",
                            print_frags=False)
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=cuda)
    chain_err, chain_sum = chain_transforms(sd, mol40, mf40, fobj40, flush,
                                            card)
    del flush
    chain_launches = chain_energies(qt, sd, mf40, fobj40, card)
    max_err = max(max_err, chain_err)
    del mf40
    torch.cuda.empty_cache()

    # ---- 10-12. the rest of the restricted driver
    fobj_fc = qt.fragmentate(mol, n_BE=2, frag_type="chemgen",
                             frozen_core=True, print_frags=False)
    later = {"octane_frozen_core": octane_frozen_core(qt, sd, mf, fobj_fc,
                                                      card),
             "hexene_iao": hexene_iao(qt, sd, card),
             "h8_sci": h8_sci(qt, sd, card)}

    # ---- 13-14. relaxed CCSD densities, the spin-orbital kernel and UBE
    later.update(octane_relaxed(qt, sd, mf, fobj, etot_matched, card))
    later["hexene_anion_ube"], ube_be1_ecorr = hexene_anion_ube(qt, sd,
                                                                card)

    # ---- 15-18. be2puffin with QM/MM, the fragmenters, ECPs, the scanner
    # and the I/O
    later["qmmm_be2puffin"] = qmmm_be2puffin(qt, sd, ube_be1_ecorr, card)
    later["fragmenters"] = fragmenters(qt, sd, mf, card)
    later["propane_ecp"] = propane_ecp(qt, sd, card)
    later["scanner_io"] = scanner_io(qt, sd, be6, card)

    # ---- 19. periodic kBE2, polyacetylene, at the default CCSD tolerance
    # of its references (phase 4 set 1e-6 for the octane phases)
    del be6
    torch.cuda.empty_cache()
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-9"):
        later["polyacetylene_kbe"] = polyacetylene_kbe(sd, card)

    # ---- 20. the fragment mesh: octane sharded against unsharded
    with _env(QUEMB_TPU_CCSD_CONV_TOL="1e-9"):
        later["fragment_mesh"] = fragment_mesh(qt, sd, mf, fobj, card)

    # ---- 21. the batched Jacobi eigh kernel at the main path's shapes
    eigh_shapes = jacobi_eigh_phase(card)

    main = timed["octane_frag0"]
    print(json.dumps({"kernels": [{
        "name": "screened_first_transform",
        "route": "cuda",
        "source": "quemb_tpu_torch/csrc/screened_first_transform.cu",
        "replaces": "quemb_tpu/ops/pallas_df.py:30",
        "launches": launches + chain_launches,
        "launches_by_path": {"octane_f32_tier": launches,
                             "c40_f32_tier": chain_launches, **later},
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cold_ms": main["cold_ms"],
        "c40_chain_38_fragments_sum": chain_sum,
        "shapes": {k: {f: v[f] for f in (
            "shape", "ms", "cold_ms", "plain_ms", "plain_cold_ms",
            "library_ms", "library_cold_ms", "bound_ms", "bound_by",
            "roofline_share_cold")} for k, v in timed.items()},
    }, {
        "name": "jacobi_eigh",
        "route": "cuda",
        "source": "quemb_tpu_torch/csrc/jacobi_eigh.cu",
        "replaces": "torch.linalg.eigh (cuSOLVER syevd); no TPU kernel",
        "bound_by": "latency: (m - 1) x sweeps dependent steps, each its"
                    " shared-memory pass over A and two barriers",
        "launches_by_phase": EIGH_BY_PHASE,
        "shapes": {k: {f: v[f] for f in (
            "ms", "wall_ms", "plain_ms", "library_ms", "library_wall_ms",
            "sweeps", "steps", "us_per_step", "bound_ms", "bound_share")}
            for k, v in eigh_shapes.items()},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
