"""The reference's reader suites run against the port: the monoid
aggregators and the aggregate / conditional readers
(``tests/test_readers_aggregate.py``), the joined readers
(``tests/test_joined_readers.py``), the Avro codec
(``tests/test_avro.py``), Parquet (``tests/test_parquet.py``, where
``pyarrow`` imports) and the file streaming reader
(``tests/test_streaming_reader.py``); ``torch_fixtures/reference_suites.py``
runs each suite's own code with its imports pointed at the port."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import reference_suites as RS  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

AGGREGATE = RS.translate("test_readers_aggregate")
JOINED = RS.translate("test_joined_readers")
AVRO = RS.translate("test_avro")
PARQUET = RS.translate("test_parquet")
STREAMING = RS.translate("test_streaming_reader")
globals().update(RS.fixtures(AGGREGATE))
globals().update(RS.fixtures(JOINED))
globals().update(RS.fixtures(AVRO))
globals().update(RS.fixtures(PARQUET))
globals().update(RS.fixtures(STREAMING))


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


@pytest.mark.parametrize("case", RS.cases(AGGREGATE, []))
def test_reference_readers_aggregate_case_on_the_port(case, request):
    RS.run(AGGREGATE, case, request)


@pytest.mark.parametrize("case", RS.cases(JOINED, []))
def test_reference_joined_readers_case_on_the_port(case, request):
    RS.run(JOINED, case, request)


@pytest.mark.parametrize("case", RS.cases(AVRO, []))
def test_reference_avro_case_on_the_port(case, request):
    RS.run(AVRO, case, request)


@pytest.mark.parametrize("case", RS.cases(PARQUET, []))
def test_reference_parquet_case_on_the_port(case, request):
    RS.run(PARQUET, case, request)


@pytest.mark.parametrize("case", RS.cases(STREAMING, []))
def test_reference_streaming_reader_case_on_the_port(case, request):
    RS.run(STREAMING, case, request)
