"""The readers of the program's own spans (perfbench/spans.py and the
metrics that read through it), each given a synthetic span list: its value;
a span that closed by an exception left out; and None where the spans are
missing, or their device times (spans recorded on the CPU)."""

import importlib.util
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f'span_reader_{name}',
                                                  HERE / 'metrics' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(name, host_ms=None, device_ms=None, error=False, **attrs):
    return {'name': name, 'attrs': attrs, 'id': 0, 'parent': None, 'thread': 1,
            'start_ns': 0, 'end_ns': 0, 'host_ms': host_ms, 'device_ms': device_ms,
            'error': error}


#: metric -> (span name, spans, value): two spans and one that failed, whose
#: numbers would move the value if it were read.
CASES = {
    'lockstep_wait_ms': ('lbfgs.gather', [dict(host_ms=10.0), dict(host_ms=30.0),
                                          dict(host_ms=1e6, error=True)], 20.0),
    'exact_factor_ms': ('exact_lml.factor', [dict(device_ms=120.0, members=60),
                                             dict(device_ms=60.0, members=30),
                                             dict(device_ms=1e6, members=1, error=True)], 2.0),
    'exact_backward_ms': ('exact_lml.backward', [dict(device_ms=90.0, members=60),
                                                 dict(device_ms=45.0, members=30),
                                                 dict(device_ms=1e6, members=1, error=True)],
                          1.5),
    'mesh_factor_ms': ('mesh_lml.factor', [dict(device_ms=80.0), dict(device_ms=100.0),
                                           dict(device_ms=1e6, error=True)], 90.0),
    'mesh_inverse_ms': ('mesh_lml.inverse', [dict(device_ms=70.0), dict(device_ms=90.0),
                                             dict(device_ms=1e6, error=True)], 80.0),
    'mesh_pairs_ms': ('mesh_lml.pairs', [dict(device_ms=110.0), dict(device_ms=130.0),
                                         dict(device_ms=1e6, error=True)], 120.0),
    'gsa_v_pass_s': ('gsa.v_pass', [dict(device_ms=1200.0, chunks=2),
                                    dict(device_ms=1000.0, chunks=2),
                                    dict(device_ms=1e6, error=True)], 1.1),
    'gsa_wt_sweep_s': ('gsa.wt_sweep', [dict(device_ms=1500.0), dict(device_ms=1700.0),
                                        dict(device_ms=1e6, error=True)], 1.6),
}


@pytest.mark.parametrize('metric', sorted(CASES))
def test_reader_value(metric):
    name, spans, value = CASES[metric]
    others = [_span('perfbench.elsewhere', host_ms=1e6, device_ms=1e6, members=1)]
    got = _reader(metric).read({}, [_span(name, **s) for s in spans] + others)
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize('metric', sorted(CASES))
def test_reader_reads_nothing_without_its_spans(metric):
    name, spans, _ = CASES[metric]
    reader = _reader(metric)
    assert reader.read({}, []) is None
    assert reader.read({}, [_span(name, **dict(s, error=True)) for s in spans]) is None
    if metric != 'lockstep_wait_ms':           # the only host-clock reader
        on_the_cpu = [_span(name, **dict(s, device_ms=None, host_ms=5.0)) for s in spans]
        assert reader.read({}, on_the_cpu) is None
