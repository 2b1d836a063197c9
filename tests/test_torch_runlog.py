"""The reference's run-ledger suite (``tests/test_runlog.py``) runs against
the port's run recorder, RUN reports, export surfaces and
``Workflow.train(progress=, run_dir=)`` (``torch_fixtures/reference_suites.py``:
the suite's own code with its imports pointed at the port, on the CPU)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import reference_suites as RS  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

RUNLOG = RS.translate("test_runlog")
globals().update(RS.fixtures(RUNLOG))


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


#: the cases that need a plane the port does not have yet: the plan audit
#: the census reconciles with and the ``runs`` CLI (A14); and the shape
#: case, which asks for the GLM fits' uploads in the census: on the CPU
#: the port's fits move no bytes between host and device
LEAVE_OUT = {
    "test_runtime_vs_static_census_reconciles",
    "TestRunsCli::test_list_and_last",
    "TestRunsCli::test_diff_clean_and_regressed",
    "TestRunsCli::test_empty_dir",
    "test_flagship_report_shape_and_validation",
}


@pytest.mark.parametrize("case", RS.cases(RUNLOG, LEAVE_OUT))
def test_reference_runlog_case_on_the_port(case, request):
    RS.run(RUNLOG, case, request)
