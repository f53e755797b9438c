"""fluidlint fixtures of the port: for each of the 26 rule ids, one source
that must fire it and one, in the port's own idiom, that must stay quiet.

The torch family marks its device-path roots with ``# fluidlint:
device-root`` (the fixture form of engine.DEVICE_PATH_ROOTS); the in-place
forms are declared by an ``IN_PLACE_ARGS`` table, as the port declares
them beside its paged ops. `harvest` reads the JAX package's own fixture
sources out of its test files, for the families whose findings must equal
the JAX analyzer's.
"""

import ast
import textwrap
from pathlib import Path


def harvest(path: Path):
    """Every multi-line string of a test file that parses as a module with
    a def or a class."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value:
            src = textwrap.dedent(node.value)
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            if "def " in src or "class " in src:
                out.append(src)
    return out


FIXTURES = {
    # -- torch: kernel hygiene on the device path ----------------------------
    "HOST_SYNC": ("""
        import torch

        # fluidlint: device-root
        def step(state: torch.Tensor, ops: torch.Tensor):
            n = int(ops.sum())
            return state + n
    """, """
        import torch

        # fluidlint: device-root
        def step(state: torch.Tensor, ops: torch.Tensor):
            n = ops.shape[0]
            return state + int(n) + ops.sum()
    """),
    "TRACED_BRANCH": ("""
        import torch

        # fluidlint: device-root
        def step(state: torch.Tensor, ops: torch.Tensor):
            if (ops > 0).any():
                state = state + 1
            return state
    """, """
        import torch

        # fluidlint: device-root
        def step(state: torch.Tensor, ops: torch.Tensor, plain=False):
            if state.device.type == "cpu" or plain:
                return state + ops
            return torch.where(ops > 0, state + 1, state)
    """),
    "RETRACE_HAZARD": ("""
        import torch

        # fluidlint: device-root
        def scan(state: torch.Tensor, ops: torch.Tensor):
            for t in range(ops.shape[1]):
                state = torch.maximum(state, ops[:, t])
            return state
    """, """
        import torch

        # fluidlint: device-root
        def scan(state: torch.Tensor, ops: torch.Tensor, k_slots: int = 3):
            for i in range(k_slots):
                state = torch.maximum(state, ops[:, i])
            return torch.amax(ops, dim=1).maximum(state)
    """),
    "SCAN_HOST_CALLBACK": ("""
        import torch

        from fluidframework_tpu_torch.parallel.mesh import note_launch

        # fluidlint: device-root
        def launch(state: torch.Tensor):
            note_launch("selftest")
            if state.sum().item() < 0:
                raise ValueError("negative")
            return state * 2
    """, """
        import torch

        from fluidframework_tpu_torch.parallel.mesh import note_launch

        # fluidlint: device-root
        def launch(state: torch.Tensor):
            if state.dim() != 2 or state.dtype != torch.int32:
                raise ValueError("selftest takes an int32 [B, N] tensor")
            note_launch("selftest")
            return state * 2
    """),
    "MUTABLE_CAPTURE": ("""
        import torch

        _PATHS = {"block": 0, "warp": 1}

        # fluidlint: device-root
        def launch(state: torch.Tensor, path: str):
            return state + _PATHS[path]
    """, """
        from types import MappingProxyType

        import torch

        _PATHS = MappingProxyType({"block": 0, "warp": 1})

        # fluidlint: device-root
        def launch(state: torch.Tensor, path: str):
            return state + _PATHS[path]
    """),
    "DTYPE_DRIFT": ("""
        import torch

        # fluidlint: device-root
        def lengths(state: torch.Tensor):
            return state.sum(dim=1, dtype=torch.float32)
    """, """
        import torch

        # fluidlint: device-root
        def lengths(state: torch.Tensor):
            idx = state.argmax(dim=1).to(torch.int64)
            return state.gather(1, idx[:, None]).to(torch.int32)
    """),
    "MISSING_DONATE": ("""
        import torch

        IN_PLACE_ARGS = {"apply_paged": (0,)}

        def apply_paged(pool, ops):
            pool.add_(ops)
            return pool

        # fluidlint: device-root
        def apply_step(pool, ops):
            pool = pool.clone()
            return apply_paged(pool, ops)
    """, """
        import torch

        IN_PLACE_ARGS = {"apply_paged": (0,)}

        def apply_paged(pool, ops):
            pool.add_(ops)
            return pool

        # fluidlint: device-root
        def apply_step(pool, ops):
            return apply_paged(pool, ops)
    """),
    # -- torch: the in-place lifecycle ---------------------------------------
    "USE_AFTER_DONATE": ("""
        IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

        def apply_ops_paged(pool, page_ids, ops):
            return pool, page_ids

        def flush(pool, page_ids, ops):
            apply_ops_paged(pool, page_ids, ops)
            return pool.length.sum()
    """, """
        IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

        def apply_ops_paged(pool, page_ids, ops):
            return pool, page_ids

        def flush(pool, page_ids, ops):
            pool, page_ids = apply_ops_paged(pool, page_ids, ops)
            return pool.length.sum()
    """),
    "DONATED_ESCAPE": ("""
        IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

        def apply_ops_paged(pool, page_ids, ops):
            return pool, page_ids

        class Store:
            def flush(self, pool, page_ids, ops):
                self.pre = pool
                apply_ops_paged(pool, page_ids, ops)
    """, """
        IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

        def apply_ops_paged(pool, page_ids, ops):
            return pool, page_ids

        class Store:
            def flush(self, page_ids, ops):
                self.pool, _ = apply_ops_paged(self.pool, page_ids, ops)
    """),
    "PAGE_ID_DTYPE": ("""
        import torch

        def stage(tables, device):
            page_ids = torch.as_tensor(tables, dtype=torch.int64,
                                       device=device)
            return page_ids
    """, """
        import torch

        def stage(tables, device):
            page_ids = torch.as_tensor(tables, dtype=torch.int32,
                                       device=device)
            return page_ids
    """),
    # -- concurrency (CC*) ---------------------------------------------------
    "AWAIT_IN_LOCK": ("""
        async def handler(self, op):
            async with self._lock:
                await self.store.write(op)
    """, """
        async def handler(self, op):
            async with self._lock:
                self.pending.append(op)
            await self.store.flush()
    """),
    "BLOCKING_IN_ASYNC": ("""
        import time

        async def poll(self):
            time.sleep(0.1)
    """, """
        import asyncio

        async def poll(self):
            await asyncio.sleep(0.1)
    """),
    "SWALLOWED_EXCEPTION": ("""
        def launch(lib, arr):
            try:
                lib.fluid_selftest(arr)
            except Exception:
                pass
    """, """
        from fluidframework_tpu_torch.telemetry.counters import record_swallow

        def launch(lib, arr):
            try:
                lib.fluid_selftest(arr)
            except Exception:
                record_swallow("kernels.selftest")
    """),
    "LISTENER_LEAK": ("""
        class Emitter:
            def on(self, event, fn):
                self._fns.setdefault(event, []).append(fn)
    """, """
        class Emitter:
            def on(self, event, fn):
                self._fns.setdefault(event, []).append(fn)

            def off(self, event, fn):
                self._fns.get(event, []).remove(fn)
    """),
    "SPAN_LEAK": ("""
        from fluidframework_tpu_torch.telemetry import tracing

        def flush(self):
            sp = tracing.start_span("flush")
            self.apply()
            sp.end()
    """, """
        from fluidframework_tpu_torch.telemetry import tracing

        def flush(self):
            with tracing.span("flush"):
                self.apply()
    """),
    "MUTABLE_DEFAULT": ("""
        def stage(ops, out=[]):
            out.extend(ops)
            return out
    """, """
        def stage(ops, out=None):
            out = [] if out is None else out
            out.extend(ops)
            return out
    """),
    "UNBOUNDED_QUEUE": ("""
        class Pump:
            def __init__(self):
                self.pending = []

            def push(self, frame):
                self.pending.append(frame)
    """, """
        from collections import deque

        class Pump:
            def __init__(self):
                self.pending = deque(maxlen=1024)

            def push(self, frame):
                self.pending.append(frame)
    """),
    # -- race (lockset) ------------------------------------------------------
    "SHARED_STATE_NO_LOCK": ("""
        import threading

        class Store:
            def __init__(self):
                self._guard_lock = threading.Lock()
                self.cache = {}

            def start(self):
                threading.Thread(target=self.work).start()

            def work(self):
                self.cache["k"] = 1

            def flush(self):
                self.cache.clear()
    """, """
        import threading

        class Store:
            def __init__(self):
                self._guard_lock = threading.Lock()
                self.cache = {}

            def start(self):
                threading.Thread(target=self.work).start()

            def work(self):
                with self._guard_lock:
                    self.cache["k"] = 1

            def flush(self):
                with self._guard_lock:
                    self.cache.clear()
    """),
    "ATOMICITY_CHECK_THEN_ACT": ("""
        import threading

        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self.windows = []

            def start(self):
                threading.Thread(target=self.push).start()

            def push(self):
                with self._lock:
                    self.windows.append(1)

            def pop(self):
                if self.windows:
                    with self._lock:
                        return self.windows.pop()
    """, """
        import threading

        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self.windows = []

            def start(self):
                threading.Thread(target=self.push).start()

            def push(self):
                with self._lock:
                    self.windows.append(1)

            def pop(self):
                with self._lock:
                    if self.windows:
                        self.windows.pop()
    """),
    "LOCK_ORDER_INVERSION": ("""
        import threading

        class Lanes:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def start(self):
                threading.Thread(target=self.one).start()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
    """, """
        import threading

        class Lanes:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def start(self):
                threading.Thread(target=self.one).start()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    with self._b:
                        pass
    """),
    "SIGNAL_WITHOUT_LOCK": ("""
        import threading

        class Waiter:
            def __init__(self):
                self._cond = threading.Condition()

            def wake(self):
                self._cond.notify_all()
    """, """
        import threading

        class Waiter:
            def __init__(self):
                self._cond = threading.Condition()

            def wake(self):
                with self._cond:
                    self._cond.notify_all()
    """),
    # -- placement -------------------------------------------------------------
    "MESH_DONATION_GATE": ("""
        from fluidframework_tpu_torch.mergetree.partition_rules import (
            POOL_PARTITION_RULES, place_with_rules)
        from fluidframework_tpu_torch.parallel.mesh import make_mesh

        IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

        def apply_ops_paged(pool, ops):
            return pool

        def serve(pool, ops):
            mesh = make_mesh(dp=4)
            pool = place_with_rules(mesh, pool, POOL_PARTITION_RULES)
            apply_ops_paged(pool, ops)
    """, """
        from fluidframework_tpu_torch.mergetree.partition_rules import (
            POOL_PARTITION_RULES, place_with_rules)
        from fluidframework_tpu_torch.parallel.mesh import make_mesh

        IN_PLACE_ARGS = {"apply_ops_paged": (0,)}

        def apply_ops_paged(pool, ops):
            return pool

        def apply_ops_paged_keep(pool, ops):
            return pool

        def serve(pool, ops):
            mesh = make_mesh(dp=4)
            pool = place_with_rules(mesh, pool, POOL_PARTITION_RULES)
            pool = apply_ops_paged_keep(pool, ops)
    """),
    "UNSPECCED_POOL": ("""
        from fluidframework_tpu_torch.mergetree.state import make_state
        from fluidframework_tpu_torch.parallel.mesh import make_mesh, map_dp

        def serve(step, ops):
            mesh = make_mesh(dp=4)
            pool = make_state(64, 1, batch=256)
            return map_dp(step, mesh, pool, ops)
    """, """
        from fluidframework_tpu_torch.mergetree.partition_rules import (
            POOL_PARTITION_RULES, place_with_rules)
        from fluidframework_tpu_torch.mergetree.state import make_state
        from fluidframework_tpu_torch.parallel.mesh import make_mesh, map_dp

        def serve(step, ops):
            mesh = make_mesh(dp=4)
            pool = place_with_rules(mesh, make_state(64, 1, batch=256),
                                    POOL_PARTITION_RULES)
            return map_dp(step, mesh, pool, ops)
    """),
    "PSPEC_MISMATCH": ("""
        from fluidframework_tpu_torch.parallel.mesh import P, make_mesh, place

        def shard(x):
            mesh = make_mesh(dp=4)
            return place(x, mesh, P("tp"))
    """, """
        from fluidframework_tpu_torch.parallel.mesh import P, make_mesh, place

        def shard(x):
            mesh = make_mesh(dp=4)
            return place(x, mesh, P("dp", None))
    """),
    "HOST_READ_OF_SHARDED": ("""
        from fluidframework_tpu_torch.parallel.mesh import (make_mesh,
                                                             shard_docs)

        def lengths(state):
            mesh = make_mesh(dp=4)
            state = shard_docs(mesh, state)
            return state.cpu()
    """, """
        from fluidframework_tpu_torch.parallel.mesh import (gather, make_mesh,
                                                             shard_docs)

        def lengths(state):
            mesh = make_mesh(dp=4)
            state = shard_docs(mesh, state)
            return gather(state).cpu()
    """),
    "SHARD_AXIS_DRIFT": ("""
        from fluidframework_tpu_torch.parallel.mesh import P, make_mesh, place

        def tiles(x):
            mesh = make_mesh(dp=2, sp=4)
            x = place(x, mesh, P("dp"))
            y = place(x, mesh, P("dp", "sp"))
            return x, y
    """, """
        from fluidframework_tpu_torch.parallel.mesh import P, make_mesh, place

        def tiles(x):
            mesh = make_mesh(dp=2, sp=4)
            x = place(x, mesh, P("dp"))
            x = place(x, mesh, P("dp", "sp"))
            return x
    """),
}
