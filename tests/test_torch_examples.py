"""The port's ``quickstart`` and ``adaptability`` examples print what the
reference's ``examples/quickstart.py`` and ``examples/adaptability.py``
print: each package's ``main`` runs once for the module and the printed
lines are compared, quickstart's solve times (``(… ms)``, a host clock)
stripped, adaptability on the CPU (``--device cpu``) line for line, one
case per pipeline."""
import contextlib
import importlib.util
import io
import os
import re

import pytest

from repro_torch.core import paper_profiles as TPP
from repro_torch.examples import adaptability, quickstart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE_TIME = re.compile(r"\(\d+ ms\)")


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(*args)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def quick():
    return {"ref": _printed(_reference("quickstart").main), "port": _printed(quickstart.main, [])}


@pytest.fixture(scope="module")
def adapt():
    return {"ref": _printed(_reference("adaptability").main),
            "port": _printed(adaptability.main, ["--device", "cpu"])}


def test_quickstart_prints_the_reference_lines(quick):
    ref, port = quick["ref"], quick["port"]
    assert len(ref) == len(port) == 14
    assert [SOLVE_TIME.sub("", x) for x in port] == [SOLVE_TIME.sub("", x) for x in ref]
    assert sum(bool(SOLVE_TIME.search(x)) for x in port) == 3


def test_adaptability_header(adapt):
    assert adapt["port"][0] == adapt["ref"][0]
    assert len(adapt["port"]) == len(adapt["ref"]) == 1 + 3 * len(TPP.PIPELINES)


@pytest.mark.parametrize("pipeline", list(TPP.PIPELINES))
def test_adaptability_lines_per_pipeline(pipeline, adapt):
    pick = lambda lines: [x for x in lines[1:] if x.split()[0] == pipeline]  # noqa: E731
    assert len(pick(adapt["port"])) == 3
    assert pick(adapt["port"]) == pick(adapt["ref"])
