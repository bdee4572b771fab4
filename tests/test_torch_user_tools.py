"""The port's last user tools on the CPU: twins of
``tests/test_tools_misc.py``'s ``test_robustness_tool``,
``test_launcher_env_contract`` and ``test_sweep_dry_run``, the FPS harness
and the FLOPs report.

Each tool runs in-process through its ``main(argv)`` with ``--device cpu``
on the JAX tests' ``TINY_CFG`` (the launchers run under bash with stand-in
``torchrun``, ``python`` and ``scontrol`` executables that record what they
were handed).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_export import TINY_CFG  # noqa: E402
from test_torch_support import REPO, voc_tree  # noqa: E402

TOOLS = os.path.join(REPO, "attentionshift_torch", "tools")


def test_robustness_tool(tmp_path, capsys):
    """P / PC / mPC over one corruption and severity on a synthetic VOC
    val set: the summary is the only column-0 JSON object printed, and
    the table holds the clean and the corrupted metric."""
    from attentionshift_torch.tools.analysis import test_robustness

    paths = voc_tree(tmp_path / "VOC2012")
    cfg = tmp_path / "rob.py"
    cfg.write_text(TINY_CFG + f"""
data.update(val=dict(split_file={paths['split_file']!r}, voc_root={paths['voc_root']!r}))
""")
    out = test_robustness.main([str(cfg), "--corruptions", "contrast", "--severities", "1",
                                "--limit", "1", "--device", "cpu", "--out",
                                str(tmp_path / "table.json")])
    stdout = capsys.readouterr().out
    summary = json.loads(stdout[stdout.index("\n{") + 1:])
    assert stdout.count("\n{") == 1 and summary == out["summary"]
    assert set(summary) >= {"P", "PC", "mPC"} and set(summary["PC"]) == {"contrast"}
    assert set(out["table"]) == {"clean", "contrast"}
    assert json.loads((tmp_path / "table.json").read_text())["metric"] == "mAP@0.5"


def test_benchmark_smoke(tmp_path, capsys):
    """The FPS harness's record: warmup, steady state, the shape and the
    device it ran on, printed as the one JSON line."""
    from attentionshift_torch.tools.analysis import benchmark

    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY_CFG)
    rec = benchmark.main([str(cfg), "--height", "64", "--width", "96", "--steps", "2",
                          "--warmup", "1", "--dtype", "float32", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["metric"] == "inference_fps" and rec["unit"] == "img/s"
    assert rec["shape"] == [1, 64, 96] and rec["device"] == "cpu" and rec["value"] > 0
    assert rec["latency_ms"] == pytest.approx(1000.0 / rec["value"], rel=0.02)


def test_get_flops_attention_count(tmp_path, capsys):
    """TINY_CFG at 96x160: T = 1 + 6 x 10 patches + 10 point tokens = 71,
    6 heads of 8, four plain blocks at test time: the attention ops count
    4 x (4 B H T^2 d) by hand; the total holds them and the other
    operators, and the parameters read are fewer than the model holds
    (the train-only heads do not run)."""
    from attentionshift_torch.config import Config
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.tools.analysis import get_flops

    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY_CFG)
    res = get_flops.main([str(cfg), "--shape", "96", "160", "--device", "cpu"])
    t = 1 + (96 // 16) * (160 // 16) + 10
    assert res["attention_flops"] == 4 * (4 * 1 * 6 * t * t * 8)
    assert res["by_op"]["attentionshift.attention_plain"] == res["attention_flops"]
    assert res["flops"] > res["attention_flops"] > 0
    held = sum(p.numel() for p in AttnShiftDetector(
        device="cpu", **Config.fromfile(str(cfg)).model.to_dict()).parameters())
    assert 0 < res["params"] < held
    out = capsys.readouterr().out
    assert "GFLOPs" in out and "attention ops:" in out


def test_sweep_dry_run():
    """The sweep expands the grid into per-run train CLI commands."""
    from attentionshift_torch.tools import sweep

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep.main(["configs/attnshift_voc12aug.py", "--grid", "model.obj_tau=0.85,0.9",
                    "--grid", "model.num_semantic_points=3,5", "--dry-run", "--",
                    "--max-steps", "5"])
    lines = [x for x in buf.getvalue().splitlines() if x.startswith("[sweep]")]
    assert len(lines) == 4
    assert "-m attentionshift_torch.tools.train configs/attnshift_voc12aug.py" in lines[0]
    assert "--cfg-options model.obj_tau=0.85 model.num_semantic_points=3" in lines[0]
    assert lines[0].endswith("--max-steps 5")
    # run names are distinct and derived from the override values
    names = [x.split()[1].rstrip(":") for x in lines]
    assert len(set(names)) == 4


def _stand_ins(tmp_path):
    """A bin dir whose ``torchrun`` and ``python`` write their arguments
    and the rendezvous variables to ``record.json``, and whose ``scontrol``
    lists two hosts."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    record = tmp_path / "record.json"
    dump = (f'#!/usr/bin/env bash\n"{sys.executable}" -c "import json, os, sys; '
            f"json.dump(dict(argv=sys.argv[1:], env={{k: os.environ.get(k) for k in "
            f"('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT', 'LOCAL_RANK')}}), "
            f"open('{record}', 'w'))\" \"$@\"\n")
    for name in ("torchrun", "python"):
        (bin_dir / name).write_text(dump)
        (bin_dir / name).chmod(0o755)
    (bin_dir / "scontrol").write_text("#!/usr/bin/env bash\nprintf 'node7\\nnode8\\n'\n")
    (bin_dir / "scontrol").chmod(0o755)
    return bin_dir, record


@pytest.mark.parametrize("launcher", ["dist_train", "dist_test", "slurm_train", "slurm_test"])
def test_launcher_env_contract(tmp_path, launcher):
    """The launchers hand the port's CLIs what ``parallel/mesh.py::
    init_distributed`` reads: through ``torchrun`` (which exports RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK itself) or
    exported from SLURM's variables; the CLI module and its arguments
    follow."""
    mesh = open(os.path.join(REPO, "attentionshift_torch", "parallel", "mesh.py")).read()
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        assert var in mesh
    bin_dir, record = _stand_ins(tmp_path)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", GPUS="4",
               SLURM_JOB_NODELIST="node[7-8]", SLURM_NTASKS="8", SLURM_PROCID="5",
               SLURM_LOCALID="1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(var, None)
    args = ["cfg.py"] + (["ckpt"] if launcher.endswith("test") else []) + ["--x", "1"]
    r = subprocess.run(["bash", os.path.join(TOOLS, f"{launcher}.sh"), *args], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    got = json.loads(record.read_text())
    cli = "attentionshift_torch.tools." + ("test" if launcher.endswith("test") else "train")
    assert got["argv"][-len(args) - 2:] == ["-m", cli, *args]
    if launcher.startswith("dist"):
        assert "--nproc_per_node=4" in got["argv"] and "--master_port=29500" in got["argv"]
    else:
        assert got["env"] == dict(RANK="5", WORLD_SIZE="8", MASTER_ADDR="node7",
                                  MASTER_PORT="29500", LOCAL_RANK="1")
