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
