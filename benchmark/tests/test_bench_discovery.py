"""New cells are new files and entries: in a copy of the benchmark, a new
stencil, configuration, traffic mix, traffic kind, limits file, check and
per-layer metric are added, found by name and run on the CPU, with no
file that was there edited."""

import hashlib
import json
import shutil

import run
from conftest import BENCH
from harness import spec

NINE_POINT = {"offsets": [[0, 0]] + [[a, b] for a in (-1, 0, 1)
                                     for b in (-1, 0, 1) if (a, b) != (0, 0)],
              "coefficients": [8.0] + [-1.0] * 8}

# a kind of traffic of its own: each call solves the sum of two pool rows
NEW_KIND = '''
from harness import check, traffic
from kinds.solve import Job as Solve

KEYS = {"rhs": {"pool"}, "pairs": {"stride"}}


class Job(Solve):
    def call(self, k, pos, keep=True, time_setup=False, spans=False):
        row = traffic.pool_index(k, self.mix["rhs"])
        other = traffic.pool_index(k + self.mix["pairs"]["stride"],
                                   self.mix["rhs"])
        b = self.rhs[row] + self.rhs[other]
        x, info = self.sysm.solve(self.op, self.amg, b)
        if keep:
            self.reservoir.offer((check.Sample(k=k, x=x, rhs_row=row), b))
        return {"info": info}

    def outputs(self):
        kept = self.reservoir.sample()
        self.pair_rhs = [b for _, b in kept]
        samples, hiers, probe = Solve.outputs(self)
        return [s for s, _ in kept], hiers, probe
'''

# a number of its own: the residual of the paired right-hand sides
NEW_CHECK = '''
from reference.solve import rel_residual


def read(j):
    return max(rel_residual(s.x, j.rhs[s.rhs_row] + j.rhs[(s.rhs_row + 1)
               % j.rhs.shape[0]], j.problem) for s in j.samples)
'''


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "_state"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digest(bench)

    (bench / "reference" / "stencils" / "9pt2d.json").write_text(
        json.dumps(NINE_POINT))
    config = json.loads((bench / "configs" / "ij_7pt_256x256x128.json")
                        .read_text())
    flags = config["ij_flags"]
    i = flags.index("-n")
    flags[i:i + 5] = ["-n", "40", "40", "1", "-9pt"]
    config.update(name="ij_9pt_40x40", grid=[40, 40], stencil="9pt2d",
                  ij_flags=flags)
    (bench / "configs" / "ij_9pt_40x40.json").write_text(json.dumps(config))
    (bench / "kinds" / "paired.py").write_text(NEW_KIND)
    mix = {"why": "x", "kind": "paired", "rhs": {"pool": 4},
           "pairs": {"stride": 1}, "warmup_calls": 1, "sample": 2,
           "trace_calls": 1}
    (bench / "traffic" / "paired_stream.json").write_text(json.dumps(mix))
    (bench / "checks" / "paired_residual.py").write_text(NEW_CHECK)
    (bench / "limits" / "ij9_paired.json").write_text(json.dumps(
        {"paired_residual": 1e-4, "cycle_gap": 1e-5, "unconverged": 0}))
    (bench / "metrics" / "calls.paired.py").write_text(
        "def read(run):\n    return float(len(run.calls)) or None\n")

    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "ij_9pt_40x40", "source": "x",
                           "file": "benchmark/configs/ij_9pt_40x40.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "ij9_paired", "config": "ij_9pt_40x40",
                             "traffic": "paired_stream", "chips": 1,
                             "why": "x"})
    doc["per_layer"].append({"name": "calls.paired", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "solve_ms",
                             "workloads": ["ij9_paired"]})
    for m in doc["end_to_end"]:
        if m["name"] == "solve_ms":
            m["workloads"].append("ij9_paired")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = spec.load_cell("ij9_paired", bench_dir=bench, root=root)
    assert [m["name"] for m in cell.per_layer] == ["calls.paired"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "solve_ms"}
    b = run.build("ij9_paired", device="cpu", bench_dir=bench, root=root)
    assert b.problem.n == 1600
    res = run.measure(b, 2 ** 41 + 9, 0.2, False, t_start=0.0)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"paired_residual", "cycle_gap",
                                  "unconverged"}
    assert set(res["metrics"]) == {"setup_s", "solve_ms"}
    res = run.measure(run.build("ij9_paired", device="cpu", bench_dir=bench,
                                root=root), 2 ** 41 + 9, 0.2, True,
                      t_start=0.0)
    assert res["metrics"]["calls.paired"]["value"] >= 1

    # the cells that were there keep their metrics, and no file changed
    old = spec.load_cell("ij7_solve", bench_dir=bench, root=root)
    assert "calls.paired" not in {m["name"] for m in old.per_layer}
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
