"""The port's measurement scripts run end to end on the CPU at a tiny size
and leave the modules they instrument as they found them."""

import json

import pytest
import torch

from tomojax_torch import align as ta
from tomojax_torch.align import pipeline as tp
from tomojax_torch.kernels import _build
from tomojax_torch.tools import (adj_split, config1, config2, config3,
                                 config4_floor, config4_profile, trace_cost)

torch.set_num_threads(1)


def test_config4_profile_splits_each_outer(tmp_path):
    before = (tp.cgls_init, tp.cgls_steps, tp.refine_views_slab,
              tp.moment_match, ta.align_reconstruct)
    out = tmp_path / "prof.json"
    config4_profile.main(["--device", "cpu", "--size", "16", "--views", "6",
                          "--outers", "2", "--out", str(out),
                          "--set", "align.recon_iters=4",
                          "--set", "align.refine_iters=2"])
    assert (tp.cgls_init, tp.cgls_steps, tp.refine_views_slab,
            tp.moment_match, ta.align_reconstruct) == before
    rep = json.loads(out.read_text())
    rows = rep["rows"]
    assert [r["outer"] for r in rows] == [0, 1]
    assert [r["profiled"] for r in rows] == [False, True]
    for r in rows:
        assert r["recon_s"] > 0 and r["refine_s"] > 0
        assert r["moment_match_s"] > 0 and r["other_s"] >= 0
        assert abs(r["recon_s"] + r["refine_s"] + r["moment_match_s"]
                   + r["other_s"] - r["wall_s"]) < 1e-9
        # a CPU run takes the plain versions: no kernel launches
        assert r["launches"] == {"K3": 0, "K4": 0, "K5": 0}
    assert rep["device"] == "cpu" and rep["kernel_s"] == 0


def test_trace_cost_times_the_recorder_and_the_chain(tmp_path):
    out = tmp_path / "cost.json"
    rep = trace_cost.main(["--device", "cpu", "--size", "16", "--views", "6",
                           "--chains", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    assert rep["device"] == "cpu" and "census" not in rep
    assert set(rep["off"]) == {"loop_us", "span_off_us", "count_off_us",
                               "span_on_us", "count_on_us"}
    assert all(v > 0 for v in rep["off"].values())
    ch = rep["chain"]
    assert ch["views"] == 5
    for k in ("untraced_view_us", "traced_view_us", "cc_view_span_us"):
        assert len(ch[k]) == 2 and all(v > 0 for v in ch[k])
    # a view's stages lie inside its span
    for i in range(2):
        assert sum(v[i] for v in ch["stage_us"].values()) <= (
            ch["cc_view_span_us"][i])
    assert 0 < rep["off_share_of_view"] < 1


def test_config4_floor_prints_both_families(capsys):
    config4_floor.main(["--device", "cpu", "--size", "16", "--views", "6",
                        "--iters", "20"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("true views")]
    assert [line.split(":")[0] for line in lines] == [
        "true views, slab", "true views, slab_plane"]
    for line in lines:
        rel = [float(tok) for tok in line.split(":")[1].split(";")[0].split()
               if not tok.startswith("@")]
        assert len(rel) == 2 and rel[1] <= rel[0] < 1.0


@pytest.mark.parametrize("kernel", sorted(adj_split.KERNELS))
def test_adj_split_variants_apply_to_the_kernel_source(kernel):
    """Each of tools/adj_split's variants of K1, K2 and the bf16 kernels
    (K1b-K4b) matches its text in the source or a header it includes
    exactly once and changes it; the occupancy entry the tool appends to
    the source names the kernel that the source defines (the tool itself
    needs the card)."""
    k = adj_split.KERNELS[kernel]
    name = k["source"].name
    texts = _build.texts(k["source"])
    assert f"{k['kernel']}(" in texts[name]
    assert f"int {k['smem']} =" in texts[name]
    for v in k["variants"]:
        out = adj_split.variant_source(kernel, v)
        assert out.keys() == texts.keys() and out != texts, v
        assert k["kernel"] in out[name]
    out = adj_split.with_occupancy(k, texts)
    assert "adj_split_occupancy" in out[name]
    assert {f: t for f, t in out.items() if f != name} == {
        f: t for f, t in texts.items() if f != name}


def test_adj_split_counting_build_applies():
    """tools/adj_split's counting build: each of its edits matches
    slab_plane.cu exactly once, one counter per (kernel, step kind), and
    the entry that reads them is appended."""
    out = adj_split.count_source()[adj_split.PLANE.name]
    assert out.count("atomicAdd(&split_steps[") == 2
    assert "split_steps[6]" in out
    assert 'extern "C" int split_step_counts(' in out
    assert "split_steps" not in adj_split.PLANE.read_text()


BASELINE_RUNS = {
    # tool, extra arguments, {record section: {entry: keys}}
    "config1": (config1, ["--cgls-iters", "5"], {"families": {
        fam: ("gen_s", "gen_proj_per_s", "cgls_s", "cgls_iters_run",
              "recon_rel_l2_vs_phantom", "final_rms")
        for fam in ("ray", "slab")}}),
    "config2": (config2, ["--sirt-iters", "5", "--fista-iters", "3"],
                {"runs": {name: ("wall_s", "iters_run", "rel_l2_vs_phantom",
                                 "final_rms")
                          for name in ("sirt_clean", "sirt_noisy",
                                       "fista_tv_clean", "fista_tv_noisy")}}),
    "config3": (config3, ["--cgls-iters", "6", "--cgls-chunk", "2"],
                {"stages": {
                    **{m: ("raw", "gauge_corrected", "wall_s")
                       for m in ("com", "cc_chain")},
                    **{f"cgls_{m}": ("rel_l2", "wall_s")
                       for m in ("misaligned", "com", "cc", "true")}}}),
}


@pytest.mark.parametrize("name", sorted(BASELINE_RUNS))
def test_baseline_config_tools_write_the_scripts_keys(name, tmp_path):
    """BASELINE configs 1-3 run on the CPU at 16³ × 8 views and write the
    keys of their scripts (scripts/config1_64.py, config2_128.py,
    config3_256.py)."""
    tool, extra, want = BASELINE_RUNS[name]
    out = tmp_path / f"{name}.json"
    rec = tool.main(["--device", "cpu", "--size", "16", "--views", "8",
                     "--out", str(out), *extra])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["device"] == {"type": "cpu", "name": "cpu"}
    for section, entries in want.items():
        assert set(entries) <= set(rec[section])
        for entry, keys in entries.items():
            got = rec[section][entry]
            assert set(keys) <= set(got), (entry, sorted(got))
    if name == "config3":
        st = rec["stages"]
        assert "gen_s" in st and rec["total_wall_s"] > 0
        for m in ("misaligned", "com", "cc", "true"):
            assert len(st[f"cgls_{m}"]["rel_l2"]) == 3
    elif name == "config2":
        assert rec["gen_s"] > 0 and rec["total_wall_s"] > 0
        assert rec["runs"]["sirt_clean"]["iters_run"] == 5
    else:
        for r in rec["families"].values():
            assert r["cgls_iters_run"] == 5 and r["recon_rel_l2_vs_phantom"] < 1
