"""SharedDirectory: hierarchical key-value DDS.

Capability parity with reference packages/dds/map/src/directory.ts (1624
LoC): a tree of subdirectories, each with its own MapKernel-style key store;
ops carry the subdirectory path; subdirectory create/delete are ops too.

A port of fluidframework_tpu's dds/directory.py: the same code, its imports
pointing into this package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..protocol.summary import SummaryTree
from .map import MapKernel
from .shared_object import SharedObject, collect_handles


class SubDirectory:
    def __init__(self, directory: "SharedDirectory", path: str):
        self.directory = directory
        self.path = path  # absolute, "/" is root
        self.kernel = MapKernel()
        self.subdirs: Dict[str, "SubDirectory"] = {}

    # -- keys --------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self.kernel.data.get(key, default)

    def set(self, key: str, value: Any) -> "SubDirectory":
        op = self.kernel.set(key, value)
        self.directory._submit_storage_op(self.path, op)
        return self

    def delete(self, key: str) -> None:
        self.directory._submit_storage_op(self.path, self.kernel.delete(key))

    def clear(self) -> None:
        self.directory._submit_storage_op(self.path, self.kernel.clear())

    def has(self, key: str) -> bool:
        return key in self.kernel.data

    def wait(self, key: str, timeout: Optional[float] = None) -> Any:
        """Block until `key` exists in THIS subdirectory and return its
        value (reference IDirectory.wait). Resolution rules match
        SharedMap.wait; events are watched on the owning SharedDirectory
        (kernel checks keep this path-scoped)."""
        from .map import wait_for
        return wait_for(
            self.directory, "valueChanged",
            lambda: (key in self.kernel.data, self.kernel.data.get(key)),
            timeout)

    def keys(self) -> Iterator[str]:
        return iter(list(self.kernel.data.keys()))

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(list(self.kernel.data.items()))

    def __len__(self) -> int:
        return len(self.kernel.data)

    # -- subdirectories ----------------------------------------------------
    def create_sub_directory(self, name: str) -> "SubDirectory":
        sub = self.subdirs.get(name)
        if sub is None:
            sub = self._create_child(name)
            self.directory._submit_create_op(self.path, name)
        return sub

    def _create_child(self, name: str) -> "SubDirectory":
        path = self.path.rstrip("/") + "/" + name
        sub = SubDirectory(self.directory, path)
        self.subdirs[name] = sub
        return sub

    def get_sub_directory(self, name: str) -> Optional["SubDirectory"]:
        return self.subdirs.get(name)

    def delete_sub_directory(self, name: str) -> None:
        if name in self.subdirs:
            del self.subdirs[name]
            self.directory._submit_delete_op(self.path, name)

    def subdirectories(self) -> Iterator[Tuple[str, "SubDirectory"]]:
        return iter(list(self.subdirs.items()))

    # -- snapshot ----------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "storage": self.kernel.data,
            "subdirectories": {name: sub.to_dict()
                               for name, sub in sorted(self.subdirs.items())},
        }

    def load_dict(self, data: dict) -> None:
        self.kernel.data = dict(data.get("storage", {}))
        for name, sub_data in data.get("subdirectories", {}).items():
            self._create_child(name).load_dict(sub_data)


class SharedDirectory(SharedObject):
    TYPE = "https://graph.microsoft.com/types/directory"

    def __init__(self, object_id: str, runtime=None):
        super().__init__(object_id, runtime)
        self.root = SubDirectory(self, "/")
        # In-flight subdirectory create/delete ops (resubmitted on reconnect
        # before storage ops so their target paths exist).
        self._pending_subdir_ops: List[dict] = []

    # Root passthrough (reference ISharedDirectory extends IDirectory).
    def get(self, key, default=None):
        return self.root.get(key, default)

    def set(self, key, value):
        self.root.set(key, value)
        return self

    def delete(self, key):
        self.root.delete(key)

    def has(self, key):
        return self.root.has(key)

    def wait(self, key, timeout=None):
        return self.root.wait(key, timeout)

    def keys(self):
        return self.root.keys()

    def items(self):
        return self.root.items()

    def create_sub_directory(self, name):
        return self.root.create_sub_directory(name)

    def get_sub_directory(self, name):
        return self.root.get_sub_directory(name)

    def get_working_directory(self, path: str) -> Optional[SubDirectory]:
        node = self.root
        for part in path.strip("/").split("/"):
            if not part:
                continue
            node = node.get_sub_directory(part)
            if node is None:
                return None
        return node

    # -- op plumbing -------------------------------------------------------
    def _submit_storage_op(self, path: str, op: dict) -> None:
        self.submit_local_message({"type": "storage", "path": path, "op": op})

    def _submit_create_op(self, path: str, name: str) -> None:
        op = {"type": "createSubDirectory", "path": path, "name": name}
        self._pending_subdir_ops.append(op)
        self.submit_local_message(op)

    def _submit_delete_op(self, path: str, name: str) -> None:
        op = {"type": "deleteSubDirectory", "path": path, "name": name}
        self._pending_subdir_ops.append(op)
        self.submit_local_message(op)

    def connect(self) -> None:
        if not self.attached:
            def scrub(sub: SubDirectory):
                sub.kernel.pending_keys.clear()
                sub.kernel.pending_clear_count = 0
                for child in sub.subdirs.values():
                    scrub(child)
            scrub(self.root)
            self._pending_subdir_ops.clear()
        super().connect()

    def process_core(self, contents, local, seq, ref_seq, client_ordinal,
                     min_seq) -> None:
        t = contents["type"]
        if t == "storage":
            sub = self.get_working_directory(contents["path"])
            if sub is not None:
                sub.kernel.process(contents["op"], local)
                self.emit("valueChanged", contents["path"],
                          contents["op"].get("key"), local)
        elif t == "createSubDirectory":
            if local:
                self._retire_subdir_op(t, contents)
            parent = self.get_working_directory(contents["path"])
            if parent is not None and contents["name"] not in parent.subdirs:
                parent._create_child(contents["name"])
                self.emit("subDirectoryCreated", contents["path"],
                          contents["name"], local)
        elif t == "deleteSubDirectory":
            if local:
                self._retire_subdir_op(t, contents)
            parent = self.get_working_directory(contents["path"])
            # Apply on the submitter too (idempotent pop): the optimistic
            # local delete already removed it, but a concurrent remote
            # create sequenced before this op resurrects the subdir — the
            # sequenced delete must then win identically on every replica.
            if parent is not None and \
                    contents["name"] in parent.subdirs:
                parent.subdirs.pop(contents["name"], None)
                self.emit("subDirectoryDeleted", contents["path"],
                          contents["name"], local)

    def _retire_subdir_op(self, op_type: str, contents: dict) -> None:
        for i, op in enumerate(self._pending_subdir_ops):
            if op["type"] == op_type and op["path"] == contents["path"] \
                    and op["name"] == contents["name"]:
                del self._pending_subdir_ops[i]
                return

    def resubmit_pending(self) -> List[Any]:
        ops: List[dict] = list(self._pending_subdir_ops)

        def walk(sub: SubDirectory):
            for op in sub.kernel.pending_ops():
                ops.append({"type": "storage", "path": sub.path, "op": op})
            for child in sub.subdirs.values():
                walk(child)
        walk(self.root)
        return ops

    def summarize_core(self) -> SummaryTree:
        # Handles serialize in their wire form, as SharedMap's do (the JAX
        # package's directory raises TypeError on a handle value: ROADMAP
        # Queue 3).
        from .shared_object import encode_handles
        return SummaryTree().add_blob("header", json.dumps(
            encode_handles(self.root.to_dict()), sort_keys=True))

    def load_core(self, tree: SummaryTree) -> None:
        from .shared_object import decode_handles
        self.root.load_dict(
            decode_handles(json.loads(tree.entries["header"].content)))

    def get_gc_data(self) -> List[str]:
        routes: List[str] = []

        def walk(sub: SubDirectory):
            collect_handles(sub.kernel.data, routes)
            for child in sub.subdirs.values():
                walk(child)
        walk(self.root)
        return routes
