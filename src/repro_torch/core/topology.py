"""Host cache topology -> steal-distance matrix for the sharded scheduler.

``ShardedReadyQueue`` visits steal victims nearest-first when given a
distance matrix (``_victim_walk``); until now only tests passed one.
``detect_topology`` derives it from the kernel's sysfs cache hierarchy
(``/sys/devices/system/cpu/cpu*/cache``) at runtime init, so on a real
multi-socket / clustered-L2 machine a dry shard steals from a sibling
sharing the closest cache before crossing a socket — the scx/sched_ext
idle-CPU-selection idiom, in user space.

Distance between two cpus is the *level of the smallest cache they
share* (L1 < L2 < L3); cpus sharing no cache fall back to NUMA-node
tiers (same node, then farthest).  Virtual shard ``s`` maps onto cpu
``s % n_cpus`` — oversubscribed runtimes wrap, matching how the OS
round-robins pinned threads.  Any parse failure, and a *flat* hierarchy
(every off-diagonal distance equal — nothing to prefer), return None,
which keeps the queue's ring walk bit-for-bit.
"""
from __future__ import annotations

import os
import re


def parse_cpu_list(s: str) -> set[int]:
    """Parse the sysfs cpulist format: ``0-3,8,10-11`` -> {0,1,2,3,8,...}."""
    out: set[int] = set()
    for part in s.strip().split(","):
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-", 1)
            out.update(range(int(a), int(b) + 1))
        else:
            out.add(int(part))
    return out


def _cpu_caches(root: str, cpu: int) -> list[tuple[int, frozenset]]:
    """(level, shared-cpu set) of each data/unified cache of ``cpu``."""
    cdir = os.path.join(root, f"cpu{cpu}", "cache")
    out = []
    if not os.path.isdir(cdir):
        return out
    for name in os.listdir(cdir):
        if not name.startswith("index"):
            continue
        idir = os.path.join(cdir, name)
        try:
            with open(os.path.join(idir, "type")) as f:
                if f.read().strip() not in ("Data", "Unified"):
                    continue        # instruction caches don't carry tasks
            with open(os.path.join(idir, "level")) as f:
                level = int(f.read())
            with open(os.path.join(idir, "shared_cpu_list")) as f:
                shared = frozenset(parse_cpu_list(f.read()))
        except (OSError, ValueError):
            continue
        out.append((level, shared))
    return out


def _numa_node(root: str, cpu: int) -> int | None:
    """The cpu's NUMA node (its ``nodeN`` sysfs link), or None."""
    try:
        for name in os.listdir(os.path.join(root, f"cpu{cpu}")):
            if re.fullmatch(r"node\d+", name):
                return int(name[4:])
    except OSError:
        pass
    return None


def detect_topology(n_shards: int,
                    root: str = "/sys/devices/system/cpu"):
    """Steal-distance matrix for ``n_shards`` scheduler shards, or None.

    Row ``i`` gives shard ``i``'s distance to every shard (0 on the
    diagonal); ``ShardedReadyQueue`` sorts its victim walk by it.  None
    means flat/undetectable — the caller keeps the plain ring walk."""
    try:
        cpus = sorted(int(m.group(1)) for m in
                      (re.fullmatch(r"cpu(\d+)", n)
                       for n in os.listdir(root)) if m)
        if not cpus:
            return None
        caches = {c: _cpu_caches(root, c) for c in cpus}
        if not any(caches.values()):
            return None
        nodes = {c: _numa_node(root, c) for c in cpus}
        max_level = max(lv for cl in caches.values() for lv, _ in cl)

        def dist(a: int, b: int) -> int:
            if a == b:
                return 0
            shared = [lv for lv, cs in caches[a] if b in cs]
            if shared:
                return min(shared)
            if nodes[a] is not None and nodes[a] == nodes[b]:
                return max_level + 1
            return max_level + 2

        n_cpu = len(cpus)
        m = [[dist(cpus[i % n_cpu], cpus[j % n_cpu])
              for j in range(n_shards)] for i in range(n_shards)]
        flat = {m[i][j] for i in range(n_shards)
                for j in range(n_shards) if i != j}
        if len(flat) <= 1:
            return None
        return m
    except Exception:               # noqa: BLE001 — any sysfs surprise
        return None                 # degrades to the ring walk
