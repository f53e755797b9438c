"""The port's framework layer held to the JAX package's: a mirror of
tests/test_framework.py, tests/test_views.py and tests/test_matrix_undo.py.

Every test runs one script through the JAX package and through
fluidframework_tpu_torch (device="cpu"), with the same pins
(testing/client_runs.pinned: client ids, clocks, interval ids, `random`,
the forced bulk route). Each script makes every assertion of the JAX test
it mirrors, on the package it is given, and returns what it observed as
plain data; the two results must be equal.
"""

import pytest
import torch

from torch_stacks import same

# One intra-op thread, as tests/test_torch_client_golden.py sets it.
torch.set_num_threads(1)


def make_env(s, server=None):
    server = server or s.local_server.LocalServer()
    loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(server))
    return server, loader


# --- mirrors tests/test_framework.py ---------------------------------------

def clicker_factory(s):
    class Clicker(s.framework.DataObject):
        """The canonical example data object (examples/data-objects/
        clicker)."""

        def initializing_first_time(self):
            self.root.set("clicks", 0)

        @property
        def value(self):
            return self.root.get("clicks")

        def click(self):
            self.root.set("clicks", self.value + 1)

    return s.framework.DataObjectFactory("clicker", Clicker)


class TestDataObjects:
    def test_create_attach_load_via_factory(self):
        def script(s):
            server, loader = make_env(s)
            runtime_factory = \
                s.framework.ContainerRuntimeFactoryWithDefaultDataStore(
                    clicker_factory(s))
            c1, clicker1 = runtime_factory.create_detached(loader, "doc")
            assert clicker1.value == 0
            clicker1.click()
            c1.attach()
            c2, clicker2 = runtime_factory.load(loader, "doc")
            assert clicker2.value == 1
            clicker2.click()
            assert clicker1.value == clicker2.value == 2
            return [clicker1.value, clicker2.value]
        same(script)

    def test_lifecycle_hooks_run_once_each(self):
        def script(s):
            calls = []

            class Probe(s.framework.DataObject):
                def initializing_first_time(self):
                    calls.append("first")

                def initializing_from_existing(self):
                    calls.append("existing")

                def has_initialized(self):
                    calls.append("has")

            factory = s.framework.DataObjectFactory("probe", Probe)
            runtime_factory = \
                s.framework.ContainerRuntimeFactoryWithDefaultDataStore(
                    factory)
            server, loader = make_env(s)
            c1, obj = runtime_factory.create_detached(loader, "doc")
            c1.attach()
            assert calls == ["first", "has"]
            runtime_factory.load(loader, "doc")
            assert calls == ["first", "has", "existing", "has"]
            return calls
        same(script)

    def test_request_routes_to_default(self):
        def script(s):
            server, loader = make_env(s)
            runtime_factory = \
                s.framework.ContainerRuntimeFactoryWithDefaultDataStore(
                    clicker_factory(s))
            c1, obj = runtime_factory.create_detached(loader, "doc")
            assert runtime_factory.request(c1, "/") is obj
            assert runtime_factory.request(c1, "/default") is obj
            with pytest.raises(KeyError):
                runtime_factory.request(c1, "/missing")
            return obj.value
        same(script)


class TestRequestHandlerChain:
    def test_datastore_routing(self):
        def script(s):
            server, loader = make_env(s)
            c1 = loader.create_detached("doc")
            ds = c1.runtime.create_datastore("store")
            channel = ds.create_channel("m", s.map.SharedMap.TYPE)
            chain = s.framework.RequestHandlerChain(
                s.framework.datastore_route_handler(c1.runtime))
            assert chain.request("/store") is ds
            assert chain.request("/store/m") is channel
            return [ds.id, channel.id]
        same(script)

    def test_chain_falls_through(self):
        def script(s):
            hits = []
            chain = s.framework.RequestHandlerChain(
                lambda p, ctx: hits.append("a") or None,
                lambda p, ctx: "resolved")
            assert chain.request("/x") == "resolved"
            assert hits == ["a"]
            parser = s.framework.RequestParser("/a/b/c?x=1&y=2")
            return [hits, parser.path_parts, parser.query,
                    parser.is_leaf(3), parser.sub_request(1).path_parts]
        same(script)


class TestSynthesize:
    def test_register_resolve_and_chain(self):
        def script(s):
            parent = s.framework.DependencyContainer()
            parent.register("logger", "parent-logger")
            child = s.framework.DependencyContainer(parent)
            child.register("store", lambda: {"fresh": True})
            scope = child.synthesize(optional=("missing",),
                                     required=("logger", "store"))
            assert scope.logger == "parent-logger"
            assert scope.store == {"fresh": True}
            assert scope.missing is None
            with pytest.raises(KeyError):
                child.synthesize(required=("absent",))
            return [scope.logger, scope.store, scope.missing]
        same(script)


def make_map_doc(s):
    server, loader = make_env(s)
    c1 = loader.create_detached("doc")
    ds = c1.runtime.create_datastore("default")
    m = ds.create_channel("m", s.map.SharedMap.TYPE)
    c1.attach()
    return server, loader, c1, m


def with_map_undo(s, m):
    mgr = s.framework.UndoRedoStackManager()
    s.framework.SharedMapUndoRedoHandler(mgr).attach(m)
    return mgr


class TestUndoRedo:
    def test_map_undo_redo(self):
        def script(s):
            server, loader, c1, m = make_map_doc(s)
            mgr = with_map_undo(s, m)
            m.set("k", 1)
            m.set("k", 2)
            seen = []
            assert mgr.undo_operation() and m.get("k") == 1
            assert mgr.undo_operation() and m.get("k") is None
            assert mgr.redo_operation() and m.get("k") == 1
            assert mgr.redo_operation() and m.get("k") == 2
            seen.append(m.get("k"))
            return seen
        same(script)

    def test_grouped_operation(self):
        def script(s):
            server, loader, c1, m = make_map_doc(s)
            mgr = with_map_undo(s, m)
            mgr.open_current_operation()
            m.set("a", 1)
            m.set("b", 2)
            mgr.close_current_operation()
            assert mgr.undo_operation()
            assert m.get("a") is None and m.get("b") is None
            return sorted(m.items())
        same(script)

    def test_new_edit_clears_redo(self):
        def script(s):
            server, loader, c1, m = make_map_doc(s)
            mgr = with_map_undo(s, m)
            m.set("k", 1)
            mgr.undo_operation()
            m.set("k", 9)
            assert not mgr.redo_operation()
            return m.get("k")
        same(script)

    def test_sequence_undo_insert_remove_annotate(self):
        def script(s):
            server, loader = make_env(s)
            c1 = loader.create_detached("doc")
            ds = c1.runtime.create_datastore("default")
            t = ds.create_channel("t", s.sequence.SharedString.TYPE)
            c1.attach()
            mgr = s.framework.UndoRedoStackManager()
            s.framework.SharedSegmentSequenceUndoRedoHandler(mgr).attach(t)
            texts = []
            t.insert_text(0, "hello")
            t.insert_text(5, " world")
            mgr.undo_operation()
            assert t.get_text() == "hello"
            mgr.redo_operation()
            assert t.get_text() == "hello world"
            t.remove_text(0, 6)
            assert t.get_text() == "world"
            mgr.undo_operation()
            assert t.get_text() == "hello world"
            texts.append(t.get_text())
            t.annotate_range(0, 5, {"bold": True})
            mgr.undo_operation()
            props = t.client.tree.get_range_property_deltas(0, 5, ["bold"])
            assert all(old["bold"] is None for _, _, old in props)
            return [texts, props]
        same(script)


class TestInterceptions:
    def test_string_attribution_props(self):
        def script(s):
            server, loader = make_env(s)
            c1 = loader.create_detached("doc")
            ds = c1.runtime.create_datastore("default")
            t = ds.create_channel("t", s.sequence.SharedString.TYPE)
            c1.attach()
            wrapped = s.framework.create_shared_string_with_interception(
                t, lambda props: {**(props or {}), "author": "me"})
            wrapped.insert_text(0, "attributed")
            deltas = t.client.tree.get_range_property_deltas(0, 5,
                                                             ["author"])
            assert all(old["author"] == "me" for _, _, old in deltas)
            assert wrapped.get_text() == "attributed"
            return deltas
        same(script)

    def test_map_interceptor(self):
        def script(s):
            server, loader, c1, m = make_map_doc(s)
            wrapped = s.framework.create_shared_map_with_interception(
                m, lambda key, value: {"v": value, "stamped": True})
            wrapped.set("k", 7)
            assert m.get("k") == {"v": 7, "stamped": True}
            return m.get("k")
        same(script)


def make_pair(s):
    server, loader = make_env(s)
    c1 = loader.create_detached("doc")
    ds1 = c1.runtime.create_datastore("default")
    ds1.create_channel("tasks",
                       s.register_collection.ConsensusRegisterCollection.TYPE)
    c1.attach()
    c2 = loader.resolve("doc")
    r1 = c1.runtime.get_datastore("default").get_channel("tasks")
    r2 = c2.runtime.get_datastore("default").get_channel("tasks")
    return server, loader, (c1, r1), (c2, r2)


class TestAgentScheduler:
    def test_single_winner(self):
        def script(s):
            server, loader, (c1, r1), (c2, r2) = make_pair(s)
            runs = []
            s1 = s.framework.AgentScheduler(c1, r1)
            s2 = s.framework.AgentScheduler(c2, r2)
            s1.pick("snapshot", lambda: runs.append("c1"))
            s2.pick("snapshot", lambda: runs.append("c2"))
            assert runs == ["c1"]
            assert s1.picked("snapshot") and not s2.picked("snapshot")
            assert s1.picked_tasks() == ["snapshot"]
            return runs
        same(script)

    def test_takeover_on_leave(self):
        def script(s):
            server, loader, (c1, r1), (c2, r2) = make_pair(s)
            runs = []
            s1 = s.framework.AgentScheduler(c1, r1)
            s2 = s.framework.AgentScheduler(c2, r2)
            s1.pick("job", lambda: runs.append("c1"))
            s2.pick("job", lambda: runs.append("c2"))
            assert runs == ["c1"]
            c1.close()
            assert runs == ["c1", "c2"]
            assert s2.picked("job")
            return runs
        same(script)

    def test_release_hands_off(self):
        def script(s):
            server, loader, (c1, r1), (c2, r2) = make_pair(s)
            runs = []
            s1 = s.framework.AgentScheduler(c1, r1)
            s2 = s.framework.AgentScheduler(c2, r2)
            s1.pick("t", lambda: runs.append("c1"))
            s2.pick("t", lambda: runs.append("c2"))
            s1.release("t")
            assert runs == ["c1", "c2"]
            assert s2.picked("t") and not s1.picked("t")
            return runs
        same(script)


# --- mirrors tests/test_views.py -------------------------------------------

def counter_view(s):
    class CounterView(s.data_object.DataObject):
        def initializing_first_time(self):
            self.root.set("count", 0)

        def render(self):
            return f"count={self.root.get('count')}"

    return CounterView


def live_pair(s):
    server, loader = make_env(s)
    c1 = loader.create_detached("doc")
    ds1 = c1.runtime.create_datastore("default")
    m1 = ds1.create_channel("m", s.map.SharedMap.TYPE)
    c1.attach()
    c2 = loader.resolve("doc")
    m2 = c2.runtime.get_datastore("default").get_channel("m")
    return server, (c1, ds1, m1), (c2, m2)


class TestViewAdapter:
    def test_render_and_rerender_on_remote_change(self):
        def script(s):
            server, (c1, ds1, m1), (c2, m2) = live_pair(s)
            obj = counter_view(s)(ds1)
            obj.initialize(existing=False)
            frames = []
            adapter = s.framework.ViewAdapter(obj)
            adapter.mount(frames.append)
            assert frames[-1] == "count=0"
            obj.root.set("count", 3)
            assert frames[-1] == "count=3"
            adapter.unmount()
            obj.root.set("count", 9)
            assert frames[-1] == "count=3"  # unmounted: no repaint
            return frames
        same(script)

    def test_rejects_viewless_objects(self):
        def script(s):
            with pytest.raises(TypeError, match="provides no view surface"):
                s.framework.ViewAdapter(object())
            return True
        same(script)

    def test_mountable_view_moves_between_surfaces(self):
        def script(s):
            server, (c1, ds1, m1), _ = live_pair(s)
            obj = counter_view(s)(ds1)
            obj.initialize(existing=False)
            view = s.framework.MountableView(obj)
            a, b = [], []
            view.mount("surface-a", a.append)
            assert a[-1] == "count=0"
            with pytest.raises(RuntimeError, match="already mounted"):
                view.mount("surface-c", b.append)
            view.unmount()
            view.mount("surface-b", b.append)
            assert b[-1] == "count=0"
            return [a, b, view.mounted_at]
        same(script)


class TestSyncedState:
    def test_use_synced_state_two_clients(self):
        def script(s):
            server, (c1, ds1, m1), (c2, m2) = live_pair(s)
            changes = []
            get1, set1 = s.framework.use_synced_state(m1, "color", "white")
            get2, _ = s.framework.use_synced_state(
                m2, "color", "white", on_change=changes.append)
            assert get1() == get2() == "white"
            set1("teal")
            assert get2() == "teal"
            assert changes == ["teal"]
            return changes
        same(script)

    def test_synced_data_object(self):
        def script(s):
            server, (c1, ds1, m1), _ = live_pair(s)
            obj = counter_view(s)(ds1)
            obj.initialize(existing=False)
            synced = s.framework.SyncedDataObject(obj, {"count": 0,
                                                        "label": "x"})
            events = []
            synced.on_state_change(lambda k, v: events.append((k, v)))
            synced.set("count", 5)
            assert synced.get("count") == 5
            assert ("count", 5) in events
            with pytest.raises(KeyError):
                synced.set("undeclared", 1)
            return [events, synced.get("label")]
        same(script)


class TestLastEdited:
    def test_tracks_latest_editor(self):
        def script(s):
            server, (c1, ds1, m1), (c2, m2) = live_pair(s)
            block = ds1.create_channel(
                "led", s.summary_block.SharedSummaryBlock.TYPE)
            tracker = s.framework.LastEditedTracker(block)
            s.framework.setup_last_edited_tracking(tracker, c1)
            assert tracker.get_last_edit_details() is None
            m2.set("edit", "by-client-2")
            details = tracker.get_last_edit_details()
            assert details is not None
            assert details["clientId"] == c2.delta_manager.client_id
            m1.set("edit", "by-client-1")
            assert tracker.get_last_edit_details()["clientId"] == \
                c1.delta_manager.client_id
            last = tracker.get_last_edit_details()
            return [details["sequenceNumber"], last["sequenceNumber"],
                    last["user"]]
        same(script)

    def test_discards_non_edit_messages(self):
        def script(s):
            server, (c1, ds1, m1), (c2, m2) = live_pair(s)
            block = ds1.create_channel(
                "led", s.summary_block.SharedSummaryBlock.TYPE)
            tracker = s.framework.LastEditedTracker(block)
            s.framework.setup_last_edited_tracking(tracker, c1)
            c1.summarize()        # summarize op: not an edit
            server.pump()
            assert tracker.get_last_edit_details() is None
            return tracker.get_last_edit_details()
        same(script)


class TestLazyDataObject:
    def test_realize_deferred_until_first_get(self):
        def script(s):
            server, (c1, ds1, m1), _ = live_pair(s)
            realized = []

            class Heavy(s.framework.LazyLoadedDataObject):
                def realize(self):
                    realized.append(self.store.id)

            c1.runtime.create_datastore("heavy")
            factory = s.framework.LazyLoadedDataObjectFactory("heavy", Heavy)
            assert realized == []
            obj = factory.get(c1.runtime, "heavy")
            assert realized == ["heavy"] and obj.realized
            factory.get(c1.runtime, "heavy")
            assert realized == ["heavy"]  # realize ran once
            return realized
        same(script)


# --- mirrors tests/test_matrix_undo.py -------------------------------------

def make_matrix_pair(s):
    server, loader = make_env(s)
    c1 = loader.create_detached("doc")
    m1 = c1.runtime.create_datastore("d").create_channel(
        "mx", s.matrix.SharedMatrix.TYPE)
    m1.insert_rows(0, 3)
    m1.insert_cols(0, 3)
    c1.attach()
    c2 = loader.resolve("doc")
    m2 = c2.runtime.get_datastore("d").get_channel("mx")
    return m1, m2


def with_matrix_undo(s, matrix):
    manager = s.framework.UndoRedoStackManager()
    s.framework.SharedMatrixUndoRedoHandler(manager).attach(matrix)
    return manager


class TestMatrixUndo:
    def test_cell_set_undo_redo(self):
        def script(s):
            m1, m2 = make_matrix_pair(s)
            undo = with_matrix_undo(s, m1)
            m1.set_cell(1, 1, "first")
            m1.set_cell(1, 1, "second")
            undo.undo_operation()
            assert m1.get_cell(1, 1) == m2.get_cell(1, 1) == "first"
            undo.undo_operation()
            assert m1.get_cell(1, 1) is None and m2.get_cell(1, 1) is None
            undo.redo_operation()
            assert m2.get_cell(1, 1) == "first"
            return [m1.extract(), m2.extract()]
        same(script)

    def test_insert_rows_undo(self):
        def script(s):
            m1, m2 = make_matrix_pair(s)
            undo = with_matrix_undo(s, m1)
            m1.insert_rows(1, 2)
            assert m2.row_count == 5
            undo.undo_operation()
            assert m1.row_count == m2.row_count == 3
            return [m1.extract(), m2.extract()]
        same(script)

    def test_remove_rows_undo_restores_cells(self):
        def script(s):
            m1, m2 = make_matrix_pair(s)
            m1.set_cell(1, 0, "keep-a")
            m1.set_cell(1, 2, "keep-b")
            undo = with_matrix_undo(s, m1)
            undo.open_current_operation()
            m1.remove_rows(1, 1)
            undo.close_current_operation()
            assert m2.row_count == 2
            undo.undo_operation()
            assert m1.row_count == m2.row_count == 3
            assert m2.get_cell(1, 0) == "keep-a"
            assert m2.get_cell(1, 2) == "keep-b"
            return [m1.extract(), m2.extract()]
        same(script)

    def test_remove_cols_undo_restores_cells(self):
        def script(s):
            m1, m2 = make_matrix_pair(s)
            m1.set_cell(0, 1, 11)
            m1.set_cell(2, 1, 22)
            undo = with_matrix_undo(s, m1)
            undo.open_current_operation()
            m1.remove_cols(1, 1)
            undo.close_current_operation()
            undo.undo_operation()
            assert m1.col_count == 3
            assert m2.get_cell(0, 1) == 11 and m2.get_cell(2, 1) == 22
            return [m1.extract(), m2.extract()]
        same(script)

    def test_undo_converges_across_clients(self):
        def script(s):
            m1, m2 = make_matrix_pair(s)
            undo = with_matrix_undo(s, m1)
            m1.set_cell(0, 0, "x")
            m2.set_cell(2, 2, "y")  # remote activity interleaves
            undo.undo_operation()
            assert m1.extract() == m2.extract()
            assert m2.get_cell(2, 2) == "y"
            assert m2.get_cell(0, 0) is None
            return m1.extract()
        same(script)
