"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either. Module names are compared whole, by
their top-level name (the part before the first dot)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "probabilistic_point_clouds_registration_tpu"}
PORT = "probabilistic_point_clouds_registration_tpu_torch"


def loaded_after(code: str) -> set:
    script = (f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "import json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_metrics_and_program_load_no_jax():
    code = f"""
from pathlib import Path
import portbench.run, portbench.roofline
from portbench.harness import check, manifest, runner, trace
import {PORT}
from {PORT}.models import odometry
from {PORT}.io import kitti
for kind in ("drivers", "metrics"):
    for f in sorted(Path("portbench", kind).glob("*.py")):
        manifest.load_module(f, "m_" + kind + "_" + f.stem.replace(".", "_"))
"""
    loaded = loaded_after(code)
    assert PORT in loaded and "portbench" in loaded
    assert not loaded & JAX, loaded & JAX


def test_reference_loads_neither_jax_nor_the_program():
    loaded = loaded_after("import portbench.reference.registration, portbench.gen.synthetic, "
                          "portbench.gen.drive, "
                          "portbench.harness.check, portbench.roofline")
    assert "portbench" in loaded
    assert not loaded & (JAX | {PORT}), loaded & (JAX | {PORT})
