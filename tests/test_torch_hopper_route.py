"""The Hopper routes of the port's kernels, on the CPU: the pure rules that
choose and size them before a launch.

The wgmma GEMM (`csrc/matmul.cu` on `csrc/hopper_tile.cuh`) and K6's wgmma
form (`csrc/ring_fused.cu`) run only on the card, where `chip_smoke.py`
holds them against their plain versions. What decides whether a product
takes them, `cuda_matmul.gemm_route` and `cuda_ring_fused.fused_route`, and
the Python mirrors of their geometry (`wgmma_plan`, `fused_plan`) run here,
with the build key and the ptxas report parser of `ops/_build.py`.
"""

import os
import re
import shutil
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_matmul_bench_torch.ops import _build
from tpu_matmul_bench_torch.ops import cuda_matmul as cm
from tpu_matmul_bench_torch.ops import cuda_ring_fused as crf

CSRC = Path(cm.__file__).resolve().parent.parent / "csrc"
BF16 = torch.bfloat16


# ------------------------------------------------------------ gemm_route

@pytest.mark.parametrize("case, args, route", [
    ("headline 16384^3", (BF16, 16384, 16384, 16384, 16384, 16384, 0, 0), "wgmma"),
    ("tall rectangle, S=2", (BF16, 28672, 8192, 2048, 4096, 8192, 0, 0, 2), "wgmma"),
    ("f16", (torch.float16, 1000, 1000, 1000, 1000, 1000, 16, 32), "wgmma"),
    ("ragged but aligned rows", (BF16, 1000, 1000, 1000, 1000, 1000, 0, 0), "wgmma"),
    ("K slab of a wider A", (BF16, 1000, 1000, 1000, 1256, 1000, 256, 0), "wgmma"),
    ("K slab one vector in", (BF16, 1000, 1000, 1000, 1256, 1000, 16, 0), "wgmma"),
    ("K slab off a vector", (BF16, 1000, 1000, 997, 1256, 1000, 6, 0), "wmma"),
    ("odd lda (26 bytes)", (BF16, 7, 5, 13, 13, 5, 0, 0), "wmma"),
    ("odd ldb (514 bytes)", (BF16, 129, 257, 64, 64, 257, 0, 0), "wmma"),
    ("ldb a whole vector", (BF16, 129, 257, 64, 64, 264, 0, 0), "wgmma"),
    ("A misaligned", (BF16, 256, 256, 256, 256, 256, 8, 0), "wmma"),
    ("B misaligned", (BF16, 256, 256, 256, 256, 256, 0, 2), "wmma"),
    ("empty K", (BF16, 256, 256, 0, 256, 256, 0, 0), "wmma"),
    ("split slab not 64-wide", (BF16, 256, 256, 96, 192, 256, 0, 0, 2), "wmma"),
    ("int8", (torch.int8, 16384, 16384, 16384, 16384, 16384, 0, 0), "wmma"),
    ("fp32", (torch.float32, 16384, 16384, 16384, 16384, 16384, 0, 0), "simt"),
    ("dtype by name", ("bfloat16", 512, 512, 512, 512, 512, 0, 0), "wgmma"),
])
def test_gemm_route(case, args, route):
    assert cm.gemm_route(*args) == route, case


def test_route_of_views_follows_their_strides_and_offsets():
    wide = torch.zeros(64, 1256, dtype=BF16)
    b = torch.zeros(1000, 64, dtype=BF16)
    assert cm._route(wide[:, 128:1128], b, 1000) == "wgmma"  # 256 bytes in
    assert cm._route(wide[:, 3:1003], b, 1000) == "wmma"     # 6 bytes in
    odd = torch.zeros(64, 13, dtype=BF16)
    assert cm._route(odd, torch.zeros(13, 8, dtype=BF16), 13) == "wmma"


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32", "int8"])
@pytest.mark.parametrize("mkn", chip_smoke.SHAPES)
def test_chip_smoke_route_table_is_the_route_rule(dtype, mkn):
    # chip_smoke.py fails a case whose launch left the route it expects;
    # that expectation is gemm_route on contiguous operands
    m, k, n = mkn
    got = cm.gemm_route(dtype, m, n, k, k, n, 0, 0)
    assert chip_smoke.expected_route(dtype, mkn) == got


def test_wgmma_cases_of_chip_smoke_take_the_wgmma_route():
    for m, k, n in chip_smoke.WGMMA_SHAPES + [s for s, _ in chip_smoke.WGMMA_PICKUP]:
        assert cm.gemm_route(BF16, m, n, k, k, n, 0, 0) == "wgmma"
    for (m, k, n), splits in chip_smoke.WGMMA_KSPLIT:
        s = cm.effective_ksplit(k, splits)
        assert s == splits  # a real split on the card
        assert cm.gemm_route(BF16, m, n, k // s, k, n, 0, 0, s) == "wgmma"
    m, k, n, k0 = chip_smoke.WGMMA_SLAB
    assert cm.gemm_route(BF16, m, n, k, k + 256, n, 2 * k0, 0) == "wgmma"


def test_cpu_products_launch_no_route():
    before = dict(cm.LAUNCHES_BY_ROUTE)
    a = torch.ones(64, 64, dtype=BF16)
    cm.cuda_matmul(a, a)
    cm.cuda_matmul_ksplit(torch.ones(64, 256, dtype=BF16), torch.ones(256, 64, dtype=BF16))
    cm.cuda_matmul_acc(a, a, torch.zeros(64, 64, dtype=BF16))
    cm.cuda_matmul_rs(a, a, torch.zeros(64, 64, dtype=BF16), torch.empty(64, 64, dtype=BF16))
    assert cm.LAUNCHES_BY_ROUTE == before
    assert set(cm.LAUNCHES_BY_ROUTE) == set(cm.ROUTES) == {
        "simt", "wmma", "wgmma", "wgmma_persistent"}


def test_route_codes_match_the_sources():
    for name in ("matmul.cu", "ring_fused.cu"):
        text = (CSRC / name).read_text()
        codes = re.search(r"enum Route : int \{([^}]*)\}", text).group(1)
        assert [c.strip() for c in codes.split(",")] == [
            "kSimt = 0", "kWmma = 1", "kWgmma = 2"], name
    # the fourth route is the persistent pickup's own entry point, no code
    assert cm.ROUTES == ("simt", "wmma", "wgmma", "wgmma_persistent")
    assert "int tmb_rs_step(" in (CSRC / "ring_rs.cu").read_text()


# ------------------------------------------------------ tiles on wgmma

def _header_constant(name: str) -> str:
    text = (CSRC / "hopper_tile.cuh").read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)


def test_wgmma_plan_mirrors_the_header():
    assert _header_constant("kSmemBudget") == "200 * 1024"
    assert cm._WGMMA_STAGE_BUDGET == 200 * 1024
    assert "< 5 ? kSmemBudget / STAGE_BYTES : 5" in (CSRC / "hopper_tile.cuh").read_text()
    assert cm._WGMMA_MAX_STAGES == 5


@pytest.mark.parametrize("tile", cm.TILES, ids=lambda t: "x".join(map(str, t)))
def test_every_tile_fits_the_wgmma_route(tile):
    plan = cm.wgmma_plan(tile)
    bm, bn, bk = tile
    assert plan["wg_m"] * plan["wg_n"] == 2  # two consumer warpgroups
    assert plan["wm"] % 64 == 0 and plan["wn"] % 64 == 0 and plan["wn"] <= 256
    assert plan["mi"] * 64 == plan["wm"]
    assert plan["a_swizzle"] == {32: 64, 64: 128}[bk]  # one A row, one swizzle span
    assert 3 <= plan["stages"] <= 5
    assert plan["smem_bytes"] <= cm.SMEM_PER_BLOCK
    # the fp32 sums a consumer thread holds stay within its 232 registers
    assert plan["mi"] * plan["wn"] // 2 <= 128


def test_wgmma_plan_at_the_headline_tiles():
    assert cm.wgmma_plan((128, 256, 64)) == {
        "wg_m": 2, "wg_n": 1, "wm": 64, "wn": 256, "mi": 1, "a_swizzle": 128,
        "stage_bytes": 49152, "stages": 4, "smem_bytes": 4 * 49152 + 1024 + 64}
    plan = cm.wgmma_plan((64, 128, 32))
    assert (plan["wg_m"], plan["wg_n"], plan["wn"], plan["stages"]) == (1, 2, 64, 5)


def test_both_tensor_core_routes_instantiate_every_tile():
    # the tile list and the kernel templates are in csrc/matmul.cuh; each
    # unit of csrc/matmul/ instantiates one route and dtype (and, on wmma,
    # one epilogue) at every tile, and csrc/matmul.cu's tmb_init inits them all
    header = (CSRC / "matmul.cuh").read_text()
    macro = re.search(r"#define TMB_TILES\(X\)(.*?)\n\n", header, re.S).group(1)
    listed = tuple(tuple(int(v) for v in t.split(","))
                   for t in re.findall(r"X\(([\d, ]+)\)", macro))
    assert listed == cm.TILES
    for dispatcher in ("launch_wmma", "launch_wgmma", "occupancy_wmma", "occupancy_wgmma",
                       "init_wmma", "init_wgmma"):
        body = header[re.search(rf"cudaError_t {dispatcher}\(", header).start():]
        body = body[:body.index("\n}\n")]
        assert "TMB_TILES(" in body, dispatcher
    units = {p.stem: p.read_text() for p in (CSRC / "matmul").glob("*.cu")}
    for kernel, unit in (("launch_wmma<__nv_bfloat16, false>", "wmma_bf16"),
                         ("launch_wmma<__nv_bfloat16, true>", "wmma_bf16_acc"),
                         ("launch_wmma<__half, false>", "wmma_f16"),
                         ("launch_wmma<__half, true>", "wmma_f16_acc"),
                         ("launch_wmma<signed char, false>", "wmma_i8"),
                         ("launch_wmma<signed char, true>", "wmma_i8_acc"),
                         ("launch_wgmma<__nv_bfloat16>", "wgmma_bf16"),
                         ("launch_wgmma<__half>", "wgmma_f16")):
        assert kernel in units[unit], unit
        init = kernel.replace("launch_", "init_")
        assert f"{unit}_init() {{ return {init}(); }}" in units[unit], unit
    init = (CSRC / "matmul.cu").read_text()
    init = init[init.index("int tmb_init()"):]
    init = init[:init.index("\n}\n")]
    for unit in units:
        assert f"{unit}_init" in init, unit


def test_default_tile_is_a_tile():
    assert cm.DEFAULT_TILE in cm.TILES


# --------------------------------------------------------- K6's wgmma form

@pytest.mark.parametrize("dtype, k, nshard, pointers, route", [
    (BF16, 2048, 512, [0, 16, 4096], "wgmma"),     # the cap
    (torch.float16, 512, 64, [0, 32], "wgmma"),
    (BF16, 264, 136, [0, 16], "wgmma"),           # 528- and 272-byte rows
    (BF16, 264, 137, [0, 16], "wmma"),            # a 274-byte W row
    (BF16, 13, 64, [0, 16], "wmma"),
    (BF16, 512, 64, [0, 8], "wmma"),              # a misaligned shard
    (BF16, 0, 64, [0, 16], "wmma"),
    (torch.int8, 2048, 512, [0, 16], "wmma"),
    (torch.float32, 2048, 512, [0, 16], "simt"),
])
def test_fused_route(dtype, k, nshard, pointers, route):
    assert crf.fused_route(dtype, k, nshard, pointers) == route


def test_fused_plan_fills_the_card_in_one_wave_at_the_cap():
    # 2048² bf16 over 4 ranks: 512-row chunks, 512-column W shards
    plan = crf.fused_plan("wgmma", 4, 512, 512, sms=132, per_sm=1)
    assert plan == {"tiles_per_rank": 32, "per_rank": 32, "grid_blocks": 128, "waves": 1}
    # the first form's 64x64 tiles: 64 a rank, 2 resident a SM, 256 blocks
    old = crf.fused_plan("wmma", 4, 512, 512, sms=132, per_sm=2)
    assert old == {"tiles_per_rank": 64, "per_rank": 64, "grid_blocks": 256, "waves": 1}


@pytest.mark.parametrize("ranks, mshard, nshard, per_sm, want", [
    (4, 256, 256, 1, (8, 8, 32, 1)),        # half the cap: a quarter of the SMs busy
    (4, 1024, 1024, 1, (128, 33, 132, 4)),  # twice the cap: four waves
    (1, 137, 200, 1, (8, 8, 8, 1)),         # ragged
    (8, 512, 512, 1, (32, 16, 128, 2)),
    (4, 512, 512, 0, (32, 0, 0, 0)),        # no resident block: refused
])
def test_fused_plan_shares(ranks, mshard, nshard, per_sm, want):
    plan = crf.fused_plan("wgmma", ranks, mshard, nshard, sms=132, per_sm=per_sm)
    assert (plan["tiles_per_rank"], plan["per_rank"], plan["grid_blocks"],
            plan["waves"]) == want


def test_fused_tiles_match_the_source():
    text = (CSRC / "ring_fused.cu").read_text()
    (tile,) = re.findall(r"using FusedTile = tmb::WgTile<(\d+), (\d+), (\d+)>;", text)
    assert tuple(map(int, tile)) == crf.FUSED_TILES["wgmma"]
    bm, bn, bk = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);", text).groups()
    assert (int(bm), int(bn), int(bk)) == crf.FUSED_TILES["wmma"]


def test_fused_parameters_fit_the_kernel_limit():
    # three 128-byte tensor maps a rank, and TmbRingArgs (4 arrays of
    # pointers and 4 ints) beside them, under 4 KB
    maps = 3 * 128 * crf.FUSED_MAX_RANKS
    args = 4 * 8 * crf.FUSED_MAX_RANKS + 4 * 4
    assert maps + args + 4 <= 4096


# ------------------------------------------------------------------ build

def _copy_csrc(tmp_path, monkeypatch) -> Path:
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_editing_a_header_changes_the_build_key(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = {name: _build.library_path(name) for name in ("matmul", "ring_fused", "ring")}
    header = csrc / "hopper_tile.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {name: _build.library_path(name) for name in before}
    assert all(after[name] != before[name] for name in before)
    # unchanged files keep their key
    header.write_text(header.read_text().removesuffix("\n// an edit\n"))
    assert {name: _build.library_path(name) for name in before} == before


def test_a_new_header_changes_the_build_key(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _build.library_path("matmul")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("matmul") != before


# A stand-in for nvcc: logs when each call starts and ends, sleeps, and
# writes its output. `-c`: an object holding the unit's name, and a ptxas
# report of one kernel named for the unit (registers: the unit name's
# length); a unit whose name holds "bad" fails. `-shared`: the library, its
# objects' contents joined.
FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as fh:
    fh.write(f"start {{time.monotonic()}} {{' '.join(args)}}\\n")
time.sleep(0.4)
if "-c" in args:
    unit = args[-1]
    if "bad" in unit:
        print(f"{{unit}}(1): error: nothing here")
        sys.exit(2)
    stem = unit.rsplit("/", 1)[-1].removesuffix(".cu")
    open(out, "w").write(unit + "\\n")
    print(f"ptxas info    : Compiling entry function '_Z{{len(stem)}}{{stem}}v' for 'sm_90a'")
    print(f"ptxas info    : Used {{len(unit)}} registers")
else:
    with open(out, "w") as fh:
        for obj in args[args.index("-o") + 2:]:
            fh.write(open(obj).read())
with open({log!r}, "a") as fh:
    fh.write(f"end {{time.monotonic()}} {{' '.join(args)}}\\n")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A csrc tree of two sources, `split` (csrc/split.cu and two units in
    csrc/split/) and `whole`, a header, a build directory of its own, and
    the fake nvcc first on PATH; returns (csrc, the nvcc log)."""
    import sys

    csrc, bin_dir, log = tmp_path / "csrc", tmp_path / "bin", tmp_path / "nvcc.log"
    (csrc / "split").mkdir(parents=True)
    for rel in ("split.cu", "split/alpha.cu", "split/beta.cu", "whole.cu"):
        (csrc / rel).write_text(f"// {rel}\n")
    (csrc / "common.cuh").write_text("#pragma once\n")
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    return csrc, log


def _calls(log: Path) -> list[tuple[str, float, str]]:
    return [(kind, float(t), args) for kind, t, args in
            (line.split(" ", 2) for line in log.read_text().splitlines())]


def test_build_starts_every_unit_before_waiting_then_links_each_source(fake_build):
    csrc, log = fake_build
    runs = _build.NVCC_RUNS
    libs = _build.build()
    calls = _calls(log)
    compiles = [c for c in calls if " -c " in c[2]]
    links = [c for c in calls if "-shared" in c[2]]
    assert len([c for c in compiles if c[0] == "start"]) == 4  # every unit, once
    assert len([c for c in links if c[0] == "start"]) == 2  # one link a source
    first_end = min(t for kind, t, _ in compiles if kind == "end")
    assert max(t for kind, t, _ in compiles if kind == "start") < first_end
    assert _build.NVCC_RUNS - runs == 6
    for name, units in (("split", ["split.cu", "split/alpha.cu", "split/beta.cu"]),
                        ("whole", ["whole.cu"])):
        assert libs[name] == _build.library_path(name)
        assert libs[name].name.startswith(f"lib{name}-") and libs[name].suffix == ".so"
        # one library of every unit's object
        assert libs[name].read_text().splitlines() == [str(csrc / u) for u in units]
    # nothing of the build is left beside the libraries and their reports
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        [lib.name for lib in libs.values()] + [lib.name + ".ptxas.txt" for lib in libs.values()])
    # built: a second build starts no nvcc
    _build.build()
    assert _build.NVCC_RUNS - runs == 6


def test_a_split_report_gives_each_units_kernels(fake_build):
    csrc, _ = fake_build
    _build.build("split")
    usage = _build.parse_ptxas(_build._ptxas_log(_build.library_path("split")).read_text())
    assert usage == {"_Z5splitv": {"registers": len(str(csrc / "split.cu"))},
                     "_Z5alphav": {"registers": len(str(csrc / "split/alpha.cu"))},
                     "_Z4betav": {"registers": len(str(csrc / "split/beta.cu"))}}


def test_a_failed_unit_raises_naming_it(fake_build):
    csrc, _ = fake_build
    (csrc / "split" / "bad.cu").write_text("// bad\n")
    with pytest.raises(_build.KernelBuildError, match=r"nvcc failed on csrc/split/bad\.cu"):
        _build.build("split")
    assert not _build.library_path("split").exists()
    assert list(_build.BUILD_DIR.iterdir()) == []  # no object, no report, no library


def test_two_processes_building_at_once_write_apart(fake_build, monkeypatch):
    pid = [101]
    monkeypatch.setattr(_build.os, "getpid", lambda: pid[0])
    first = _build._start("split")
    pid[0] = 202
    second = _build._start("split")
    objects = [obj for job in (first, second) for _, obj, _ in job.procs]
    assert len(set(objects)) == 6
    _build._finish(first)
    _build._finish(second)
    assert _build.library_path("split").is_file()
    assert not [p for p in _build.BUILD_DIR.iterdir() if p.suffix in (".o", ".tmp")]


@pytest.mark.parametrize("edit", ["split.cu", "split/alpha.cu", "split/beta.cu",
                                  "split/gamma.cu"])
def test_editing_any_unit_changes_its_sources_key(fake_build, edit):
    csrc, _ = fake_build
    before = {name: _build.library_path(name) for name in ("split", "whole")}
    path = csrc / edit
    path.write_text((path.read_text() if path.exists() else "") + "// an edit\n")
    assert _build.library_path("split") != before["split"]
    assert _build.library_path("whole") == before["whole"]


def test_k1s_units_are_its_source_and_its_directory():
    names = [p.relative_to(CSRC).as_posix() for p in _build.units("matmul")]
    assert names[0] == "matmul.cu"
    assert sorted(names[1:]) == sorted(f"matmul/{u}.cu" for u in (
        "wmma_bf16", "wmma_bf16_acc", "wmma_f16", "wmma_f16_acc", "wmma_i8", "wmma_i8_acc",
        "wgmma_bf16", "wgmma_f16"))
    assert [p.name for p in _build.units("ring_rs")] == ["ring_rs.cu"]
    # the units compile to objects with the library's flags, the link makes it shared
    assert "-shared" not in _build.COMPILE_FLAGS and "-c" in _build.COMPILE_FLAGS
    assert set(_build.COMPILE_FLAGS) - {"-c"} == set(_build.NVCC_FLAGS) - {"-shared"}
    assert "-shared" in _build.LINK_FLAGS


PTXAS_WARNINGS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110wgmma_gemmI13__nv_bfloat16Li128ELi256ELi64EEEvPKvS3_' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '_ZN12_GLOBAL__N_110wgmma_gemmI13__nv_bfloat16Li128ELi256ELi64EEEvPKvS3_'.
ptxas info    : Function properties for _ZN12_GLOBAL__N_110wgmma_gemmI13__nv_bfloat16Li128ELi256ELi64EEEvPKvS3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ring_fused_wgmmaI6__halfEEvNS_8RingMapsE11TmbRingArgsi' for 'sm_90a'
ptxas warning : (C7508) Potential Performance Loss: setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Function properties for _ZN12_GLOBAL__N_116ring_fused_wgmmaI6__halfEEvNS_8RingMapsE11TmbRingArgsi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19wmma_gemmI13__nv_bfloat16Lb1ELi128ELi128ELi32ELb0EEEvPKT_S4_Pv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19wmma_gemmI13__nv_bfloat16Lb1ELi128ELi128ELi32ELb0EEEvPKT_S4_Pv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers
"""


def test_ptxas_warnings_go_to_their_kernels():
    usage = _build.parse_ptxas(PTXAS_WARNINGS)
    gemm, fused, wmma = (next(k for k in usage if tag in k)
                         for tag in ("wgmma_gemm", "ring_fused_wgmma", "wmma_gemm"))
    assert usage[gemm]["warnings"] == ["wgmma_serialized"]
    assert usage[gemm]["registers"] == 168
    assert usage[fused]["warnings"] == ["setmaxnreg_ignored"]
    assert "warnings" not in usage[wmma] and usage[wmma]["registers"] == 128


def test_ptxas_warning_naming_another_kernel_goes_to_that_kernel():
    text = ("ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
            "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
            "instructions are serialized due to insufficient register resources "
            "for the wgmma pipeline in the function '_Z1bv'\n"
            "ptxas info    : Used 10 registers\n")
    usage = _build.parse_ptxas(text)
    assert usage["_Z1bv"] == {"warnings": ["wgmma_serialized"]}
    assert usage["_Z1av"] == {"registers": 10}


def test_the_build_flags_need_no_libcuda():
    assert "-lcuda" not in _build.NVCC_FLAGS
    assert "cudaGetDriverEntryPoint" in (CSRC / "hopper_tile.cuh").read_text()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ----------------------------------------------------------------- raster

@pytest.mark.parametrize("tm, tn", [(128, 64), (64, 128), (13, 5), (5, 13), (1, 1), (9, 17)])
@pytest.mark.parametrize("m_slow", [True, False])
def test_raster_visits_every_tile_once(tm, tn, m_slow):
    tiles = [cm.raster(b, tm, tn, m_slow) for b in range(tm * tn)]
    assert sorted(tiles) == [(m, n) for m in range(tm) for n in range(tn)]


def test_raster_keeps_a_wave_on_few_bands():
    # 16384^2 in 128x256 tiles: 128 M tiles, 64 N tiles; a wave of 132
    # blocks touches 8 bands of A and 17 of B ("mnk"), not all 64 of B
    wave = [cm.raster(b, 128, 64, True) for b in range(132)]
    assert len({m for m, _ in wave}) == 8 and len({n for _, n in wave}) == 17
    wave = [cm.raster(b, 128, 64, False) for b in range(132)]
    assert len({n for _, n in wave}) == 8 and len({m for m, _ in wave}) == 17


def test_raster_group_matches_the_header():
    assert _header_constant("kGroup") == str(cm.RASTER_GROUP)
