"""The reference's out-of-core fit suite (``tests/test_stream_fit.py``) and
its property suite (``tests/test_stream_property.py``) run against the
port's ``workflow/stream.py``, ``readers/streaming.py``, checkpoints and
``Workflow.train(stream=True)`` (``torch_fixtures/reference_suites.py``:
the suite's own code with its imports pointed at the port, on the CPU)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import reference_suites as RS  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

FIT = RS.translate("test_stream_fit")
PROPERTY = RS.translate("test_stream_property")
globals().update(RS.fixtures(FIT))

#: needs the distributed plane's ``resilience`` ledger source (A13)
LEAVE_OUT = {"test_stream_counters_reach_resilience_source"}


@pytest.fixture(autouse=True)
def _cpu_default():
    with RS.cpu_default():
        yield


@pytest.fixture
def fault_plan():
    from transmogrifai_tpu_torch.resilience import faults

    plan = faults.FaultPlan()
    with faults.installed(plan):
        yield plan


@pytest.mark.parametrize("case", RS.cases(FIT, LEAVE_OUT))
def test_reference_stream_fit_case_on_the_port(case, request):
    RS.run(FIT, case, request)


@pytest.mark.parametrize("case", RS.cases(PROPERTY))
def test_reference_stream_property_case_on_the_port(case, request):
    RS.run(PROPERTY, case, request)
