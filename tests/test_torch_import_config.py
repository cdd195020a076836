"""The port's recipe importer against the JAX package's
(tools/import_config.py ``normalize``), on every recipe under configs/:
the same keys and values in the same order, the provenance header apart
(it names the schema it validated against), and both refuse the same
recipes."""

import glob
import os

import pytest

from slowfast_tpu_torch.import_config import main, normalize
from tools.import_config import normalize as jax_normalize

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAMLS = sorted(os.path.relpath(p, ROOT)
               for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def body(text):
    return [line for line in text.splitlines() if not line.startswith("#")]


def run(fn, path):
    try:
        return fn(path, "note")[0], None
    except Exception as e:  # noqa: BLE001 -- the refusal itself is compared
        return None, type(e).__name__


@pytest.mark.parametrize("path", YAMLS)
def test_normalize_matches_jax(path):
    got, got_err = run(normalize, os.path.join(ROOT, path))
    want, want_err = run(jax_normalize, os.path.join(ROOT, path))
    assert got_err == want_err
    if got is not None:
        assert body(got) == body(want)
        assert got.splitlines()[0] == want.splitlines()[0] and "# note" in got


def test_cli_writes_recipes(tmp_path, capsys):
    src = os.path.join(ROOT, "configs", "Kinetics", "SLOWFAST_4x16_R50.yaml")
    main([src, "--out-dir", str(tmp_path)])
    written = tmp_path / "SLOWFAST_4x16_R50.yaml"
    assert "wrote" in capsys.readouterr().out
    assert written.read_text() == normalize(src)[0]
