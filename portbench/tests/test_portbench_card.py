"""What only the card can show: the device trace's markers tie the
profiler's clock to the host's. Run on a machine with a card:

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_card.py
"""

import threading
import time

import pytest


@pytest.mark.cuda
def test_portbench_device_trace_marks_its_window():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from portbench.devtrace import DeviceTrace
    x = torch.ones(1 << 20, device="cuda")
    trace = DeviceTrace()
    trace.start()
    trace.mark()
    t0 = time.monotonic()

    def work():  # kernels from another thread, as the server's
        y = x
        for _ in range(50):
            y = y * 1.0001
            time.sleep(0.002)
        torch.cuda.synchronize()
    th = threading.Thread(target=work)
    th.start()
    th.join()
    trace.mark()
    t1 = time.monotonic()
    trace.stop()
    got = trace.read()
    assert got["marked"]
    assert 0 < got["busy_s"] < got["window_s"]
    assert abs(got["window_s"] - (t1 - t0)) < 0.05
    idle = sum(b - a for a, b in got["idle"])  # host seconds
    assert abs(idle + got["busy_s"] - (t1 - t0)) < 0.02
