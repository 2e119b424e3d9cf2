"""No module the harness or the reference loads is JAX, the JAX package
or scikit-learn (top-level names compared whole: the port's name begins
with the JAX package's), and the reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "fed_tgan_tpu", "sklearn"}

PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.harness, benchmark.check, benchmark.program
import benchmark.devtrace, benchmark.counts
import benchmark.reference.init, benchmark.reference.ctgan
import benchmark.reference.sample
for name in {readers!r}:
    benchmark.harness.reader(name)
{ref_only}
# what the harness imports of the port when it runs a cell
import fed_tgan_torch.data.ingest, fed_tgan_torch.data.sharding
import fed_tgan_torch.datasets, fed_tgan_torch.federation.init
import fed_tgan_torch.train.federated, fed_tgan_torch.train.snapshots
import fed_tgan_torch.runtime.profiling, fed_tgan_torch.ops.activate_cuda
import fed_tgan_torch.cli
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(ref_only: str = "") -> set:
    readers = [p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.py")]
    code = PROBE.format(root=str(ROOT), readers=readers, ref_only=ref_only)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_no_jax_and_no_sklearn_in_a_run():
    assert not _top_level() & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = ("assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'fed_tgan_torch'], 'port loaded'")
    _top_level(code)


def test_sources_import_nothing_forbidden():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN, (path, tops)
            if "reference" in path.parts:
                assert "fed_tgan_torch" not in tops, path
