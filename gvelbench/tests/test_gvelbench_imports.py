"""Nothing the benchmark loads is jax or the JAX package: top-level module
names compared whole (``repro_torch`` begins with ``repro``)."""
import subprocess
import sys

from gvelbench import harness


def test_forbidden_names_are_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core", "jaxtyping", "reprox",
            "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(
        mods + ["repro", "repro.core.loader", "jax.numpy", "jaxlib", "flax"]
    ) == ["flax", "jax.numpy", "jaxlib", "repro", "repro.core.loader"]


def test_a_cpu_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from gvelbench import harness\n"
        "if __name__ == '__main__':\n"
        "    r, found = harness.run('graph500-s22.csr', 5, 0.2, False,"
        " t0=time.monotonic(), device='cpu', cfg_override={'scale': 10},"
        " patch='gvelbench.tests.patches:count_cpu_launches',"
        " say=lambda m: None)\n"
        "    assert r['correct'], r\n"
        "    print(found, harness.forbidden_modules())\n"
        "    assert 'repro_torch' in sys.modules\n"
    ) % str(harness.ROOT)
    script = tmp_path / "run.py"
    script.write_text(code)
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "[] []"
