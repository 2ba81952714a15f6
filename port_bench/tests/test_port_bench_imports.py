"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the references load nothing of the port."""

import subprocess
import sys
import textwrap

from port_bench import core

CHECK_ALL = textwrap.dedent("""
    import importlib.util, json, sys
    sys.path.insert(0, {checkout!r})
    spec = importlib.util.spec_from_file_location("port_bench_run", {run!r})
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from port_bench import core, control
    bench = core.Bench()
    for kind in ("refs", "counts", "inputs", "metrics"):
        for path in sorted((bench.dir / kind).glob("*.py")):
            bench.load(kind, path.stem)
    for config in bench.spec["configs"]:
        core.resolve(json.loads((bench.checkout / config["file"]).read_text())["entry"])
    print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
""")

CHECK_REFS = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {checkout!r})
    from port_bench import core
    bench = core.Bench()
    for path in sorted((bench.dir / "refs").glob("*.py")):
        bench.load("refs", path.stem)
    print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
""")


def top_level_names(script: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", script.format(
        checkout=str(core.BENCH_DIR.parent), run=str(core.BENCH_DIR / "run.py"))],
        capture_output=True, text=True, timeout=300, check=True)
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_references_counts_inputs_metrics_and_entries_load_no_jax():
    names = top_level_names(CHECK_ALL)
    assert "various_image_processings_tpu_torch" in names  # the entries were resolved
    assert "torch" in names and "port_bench" in names
    assert not set(names) & {"jax", "jaxlib", "flax", "various_image_processings_tpu"}
    assert set(core.FORBIDDEN) == {"jax", "jaxlib", "flax", "various_image_processings_tpu"}


def test_references_load_nothing_of_the_port():
    names = top_level_names(CHECK_REFS)
    assert "port_bench" in names
    assert not set(names) & {"various_image_processings_tpu_torch", "jax", "jaxlib",
                             "various_image_processings_tpu"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types
    fake = types.SimpleNamespace(modules={"various_image_processings_tpu_torch.ops": None,
                                          "jaxtyping": None, "torch": None})
    monkeypatch.setattr(core, "sys", fake)
    assert core.forbidden_modules() == []
    fake.modules.update({"jaxlib.xla_client": None, "various_image_processings_tpu.ops": None})
    assert core.forbidden_modules() == ["jaxlib", "various_image_processings_tpu"]
