"""The port stands alone: no file of pt_three_ways_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package, and a process that imports
the port and renders on the CPU never loads jax, nor does any rank of
``cli --devices 2 --device cpu``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pt_three_ways_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "pt_three_ways_tpu"), (path, mod)


def test_port_renders_without_loading_jax(tmp_path):
    code = (
        "import sys\n"
        "from pt_three_ways_tpu_torch.models.catalog import create_scene\n"
        "from pt_three_ways_tpu_torch.models.render import render\n"
        "from pt_three_ways_tpu_torch.models.scene import SceneBuilder\n"
        "from pt_three_ways_tpu_torch.utils.render_params import RenderParams\n"
        "import pt_three_ways_tpu_torch.cli, pt_three_ways_tpu_torch.ops.megakernel\n"
        "p = RenderParams(width=8, height=8, samples_per_pixel=1, max_depth=3,\n"
        "                 first_bounce_u_samples=2, first_bounce_v_samples=2)\n"
        "sb = SceneBuilder(); cam = create_scene(sb, 'cornell', p)\n"
        "out = render(sb.build(), cam, p, device='cpu')\n"
        "assert out.total_samples() == 64\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pt_three_ways_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")

    # the sharded CLI's ranks are processes of their own: a stand-in jax
    # package ahead of the real one on their path records any import of
    # it (and fails it); the run must succeed and record none
    for name in ("jax", "jaxlib", "pt_three_ways_tpu"):
        fake = tmp_path / "shadow" / name
        fake.mkdir(parents=True)
        (fake / "__init__.py").write_text(
            "import os\n"
            "open(os.environ['PT3_JAX_MARK'], 'a').write(f'{os.getpid()} {__name__}\\n')\n"
            "raise ImportError(__name__ + ' is not for the port')\n")
    mark = tmp_path / "jax_imports.txt"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "shadow"), ROOT]),
               PT3_JAX_MARK=str(mark))
    out = tmp_path / "two.raw"
    r = subprocess.run([sys.executable, "-m", "pt_three_ways_tpu_torch.cli", "-w", "8", "-h",
                        "8", "--spp", "2", "--max-depth", "3", "--first-bounce-u", "2",
                        "--first-bounce-v", "2", "--save-every", "0", "--raw", "--devices",
                        "2", "--device", "cpu", str(out)],
                       cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Total samples: 128" in r.stdout
    assert not mark.exists(), mark.read_text()


def test_chip_smoke_alone_fails(tmp_path):
    """Without a card (or beside nothing of the repo) the script exits
    non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
