"""The port's UMT runtime: ``shutdown`` racing a worker spawn.

The leader thread spawns workers while ``shutdown`` may be joining them.
A spawn held between creating its worker and starting it must neither
make ``shutdown`` join a thread that was never started (``RuntimeError:
cannot join thread before it is started``) nor leave a worker running
after ``shutdown`` returned; and once ``shutdown`` has begun, nothing is
spawned at all.  The hold is a patched ``Worker.start`` that waits on an
event, so the interleaving is forced, not left to timing.
"""
import threading

from repro_torch.core import runtime


def _in_thread(fn, box, key):
    def run():
        try:
            box[key] = fn()
        except Exception as e:              # noqa: BLE001 — checked below
            box[key + "_exc"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_shutdown_during_a_held_spawn_joins_only_started_workers(
        monkeypatch):
    rt = runtime.UMTRuntime(n_cores=1, umt=False, trace=False)
    entered, go = threading.Event(), threading.Event()
    real_start = runtime.Worker.start

    def held_start(self):
        entered.set()
        assert go.wait(10)
        real_start(self)

    monkeypatch.setattr(runtime.Worker, "start", held_start)
    box = {}
    spawner = _in_thread(lambda: rt._spawn(0), box, "spawn")
    assert entered.wait(10)
    stopper = _in_thread(rt.shutdown, box, "shutdown")
    stopper.join(0.2)               # shutdown gets as far as it can
    go.set()
    spawner.join(10)
    stopper.join(10)
    assert not spawner.is_alive() and not stopper.is_alive()
    assert "shutdown_exc" not in box, repr(box.get("shutdown_exc"))
    assert "spawn_exc" not in box, repr(box.get("spawn_exc"))
    assert not rt.running
    assert all(w.ident is not None for w in rt._workers)   # all started
    for w in rt._workers:
        w.join(5)
        assert not w.is_alive()


def test_no_spawn_once_shut_down():
    rt = runtime.UMTRuntime(n_cores=2, umt=False, trace=False)
    rt.shutdown()
    n = len(rt._workers)
    spawned = rt.stats_extra["spawned"]
    assert rt._spawn(0) is None
    assert len(rt._workers) == n and rt.stats_extra["spawned"] == spawned
