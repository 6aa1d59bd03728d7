"""sampler_bench.py's SASS reading, on the CPU: the main-path walk that
gives the instructions a thread of the self-contained coords kernel issues
(PERF.md's issue-rate floor) over small hand-written listings in
cuobjdump's format."""
import pytest

import sampler_bench as sb
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _listing(lines):
    return "\n".join(f"        /*{a:04x}*/                   {text} ;"
                     f"                /* 0x000000000000000 */" for a, text in lines)


MAIN = [(0x00, "S2R R0, SR_TID.X"),
        (0x10, "LOP3.LUT P0, RZ, R2, 0x100, RZ, 0xc0, !PT"),
        (0x20, "@!P0 BRA 0x60"),
        (0x30, "DMUL R4, R2, UR4"),               # the IBIS block's slow range reduction
        (0x40, "FADD R4, R4, R2"),
        (0x50, "FMUL R4, R4, R2"),
        (0x60, "FCHK P1, R3, R4"),
        (0x70, "@!P1 BRA 0xa0"),
        (0x80, "CALL.REL.NOINC 0x100"),          # the division's slow path
        (0x90, "BRA 0xb0"),
        (0xa0, "MUFU.RCP R5, R4"),
        (0xb0, "STG.E desc[UR4][R6.64], R5"),
        (0xc0, "EXIT"),
        (0xd0, "BRA 0xd0"),
        (0x100, "FFMA R5, R4, R3, RZ"),
        (0x110, "RET.REL.NODEC R2 0x0")]


def test_instructions_parse():
    ins = sb._sass_instructions(_listing(MAIN))
    assert len(ins) == len(MAIN)
    assert ins[2] == (0x20, "@!P0", "BRA", "0x60")
    assert ins[11][2] == "STG.E"


def test_main_path_skips_flag_blocks_and_slow_paths():
    # 0x00, 0x10, 0x20 (no IBIS: taken), 0x60, 0x70 (fast division: taken),
    # 0xa0, 0xb0, 0xc0
    assert sb.main_path_instructions(sb._sass_instructions(_listing(MAIN))) == (8, 0)


def test_a_redefined_predicate_is_not_a_flag_test():
    lines = list(MAIN)
    lines.insert(2, (0x18, "FSETP.GT.AND P0, PT, R2, RZ, PT"))
    lines[3] = (0x20, "@!P0 BRA 0x60")
    n, f64 = sb.main_path_instructions(sb._sass_instructions(_listing(lines)))
    # the branch after the compare falls through into the block: its DMUL counts
    assert (n, f64) == (12, 1)


@pytest.mark.parametrize("flag", ["0x100", "0x800"])
def test_uniform_flag_tests(flag):
    lines = [(0x00, f"ULOP3.LUT UP0, URZ, UR4, {flag}, URZ, 0xc0, !UPT"),
             (0x10, "@!UP0 BRA 0x30"),
             (0x20, "FADD R1, R1, R1"),
             (0x30, "EXIT")]
    assert sb.main_path_instructions(sb._sass_instructions(_listing(lines))) == (3, 0)


# ---- gyroflow_torch.experiments.probe_bench's pure helpers ------------------

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120probe_sampler_kernelILi1ELi3ELi0EEEvPKfS2_S2_PKiS4_S4_S2_8ProbeArgsiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120probe_sampler_kernelILi1ELi3ELi0EEEvPKfS2_S2_PKiS4_S4_S2_8ProbeArgsiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem, 468 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120window_colsum_kernelEPKfiiPKiS3_iiiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120window_colsum_kernelEPKfiiPKiS3_iiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124window_colsum_tma_kernelE14CUtensorMap_stPKfiiPKiS4_iiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124window_colsum_tma_kernelE14CUtensorMap_stPKfiiPKiS4_iiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 564 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114sampler_kernelItLi1ELi8EEEvPKT_iiPKfS5_PKhiiS5_N2gf11SamplerArgsEPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114sampler_kernelItLi1ELi8EEEvPKT_iiPKfS5_PKhiiS5_N2gf11SamplerArgsEPf
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1024 bytes smem, 420 bytes cmem[0]
"""


def test_probe_bench_ptxas_report():
    from gyroflow_torch.experiments import probe_bench as pb

    got = pb.ptxas_report(PTXAS_LOG)
    assert got == {"probe_sampler_kernelILi1ELi3ELi0EE": {"spill": [0, 0], "registers": 40},
                   "window_colsum_kernel": {"spill": [0, 0], "registers": 22},
                   "window_colsum_tma_kernel": {"spill": [0, 0], "registers": 32},
                   "sampler_kernelItLi1ELi8EE": {"spill": [4, 8], "registers": 64}}
    assert pb.ptxas_report(PTXAS_LOG, ("window_colsum_kernel",)) == {
        "window_colsum_kernel": {"spill": [0, 0], "registers": 22}}
    assert pb.ptxas_report("") == {}


def test_probe_bench_order_and_summary():
    from gyroflow_torch.experiments import probe_bench as pb

    assert pb.order(["a", "b", "c"]) == ["a", "b", "c", "c", "b", "a"]
    assert pb.order(["a"]) == ["a", "a"]

    def reading(t):
        return {"probe5 Y": {"ms": t, "err": 0.0}, "probe5 UV": {"ms": t / 4, "err": 0.5},
                "probe4 full": {"ms": 2 * t, "err": 0.0},
                **{c: {"ms": t / 10, "err": 0.0, "path": "tma"} for c in pb.SUMS["window"]}}

    s = pb.summarise({"A": [reading(0.4), reading(0.6)], "B": [reading(0.2), reading(0.2)]})
    a, b = s["A"], s["B"]
    assert a["cases"]["probe5 Y"]["ms"] == [0.4, 0.6]
    assert a["cases"]["probe5 Y"]["mean_ms"] == pytest.approx(0.5)
    assert a["cases"]["probe5 UV"]["max_err"] == 0.5
    assert a["sums"] == {"probe5 Y+UV": pytest.approx(0.625),     # fused_bbox not read
                         "window": pytest.approx(0.2)}
    assert b["cases"]["probe4 full"]["mean_ms"] == pytest.approx(0.4)
    assert "path" not in b["cases"]["probe4 full"]
    assert b["cases"]["window align8 Sc160"]["path"] == "tma"


def test_probe_bench_cases_cover_phase7():
    """Every probe-sampler mode and precision of probes 4-6, both
    fused_bbox planes and probe 3's four window cases, each once, and the
    window's three cases of its fixed cost and overlap, outside its sum."""
    from gyroflow_torch.experiments import perf_probe3 as p3
    from gyroflow_torch.experiments import perf_probe4 as p4, perf_probe6 as p6
    from gyroflow_torch.experiments import probe_bench as pb

    names = [c[0] for c in pb.CASES]
    assert len(set(names)) == len(names)
    assert {m for _, k, m, _ in pb.CASES if k == "p4"} == set(p4.MODES)
    assert {p for _, k, _, p in pb.CASES if k == "p6"} == set(p6.PRECISIONS)
    windows = {f"p3 {a} {sc}" for a, sc in p3.CASES}
    assert {k for _, k, _, _ in pb.CASES} == {"p4", "p5 Y", "p5 UV", "p6", "fb Y", "fb UV",
                                              "p3 1 tile", "p3 same", "p3 disjoint"} | windows
    assert [c[0] for c in pb.CASES if c[1] in windows] == [
        f"window align{a} Sc{sc}" for a, sc in p3.CASES]      # run_all's names
    assert all(m == "window" for _, k, m, _ in pb.CASES if k in windows)
    assert pb.SUMS["window"] == tuple(f"window align{a} Sc{sc}" for a, sc in p3.CASES)
    assert all(all(c in names for c in parts) for parts in pb.SUMS.values())
