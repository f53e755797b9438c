"""The port's code loader, base host and legacy client-api Document held to
the JAX package's: a mirror of tests/test_code_loading.py.

Every test runs one script through the JAX package and through
fluidframework_tpu_torch (device="cpu"), with the same pins
(testing/client_runs.pinned). Each script makes every assertion of the
JAX test it mirrors and returns what it observed; the results must be
equal. The entry points that build a Loader take the card by default and
raise without CUDA.
"""

import pytest
import torch

from torch_stacks import same

torch.set_num_threads(1)


def notes_factory(s):
    class Notes(s.data_object.DataObject):
        def initializing_first_time(self):
            self.root.set("title", "untitled")

    return s.data_object.DataObjectFactory("notes", Notes)


def make_runtime_factory(s):
    return s.factories.ContainerRuntimeFactoryWithDefaultDataStore(
        notes_factory(s))


class TestSemver:
    def test_ranges(self):
        def script(s):
            satisfies = s.code_loader.satisfies
            assert satisfies("1.2.3", "1.2.3")
            assert not satisfies("1.2.4", "1.2.3")
            assert satisfies("1.9.0", "^1.2.3")
            assert not satisfies("2.0.0", "^1.2.3")
            assert satisfies("1.2.9", "~1.2.3")
            assert not satisfies("1.3.0", "~1.2.3")
            assert satisfies("9.9.9", "*")
            return [satisfies(v, r) for v in ("0.9.9", "1.2.3", "1.3.0",
                                              "2.0.0")
                    for r in ("^1.2.3", "~1.2.3", "latest", "", "1.3.0")]
        same(script)

    def test_highest_matching_wins(self):
        def script(s):
            cl = s.code_loader.CodeLoader()
            cl.register("app", "1.0.0", "old")
            cl.register("app", "1.5.0", "new")
            cl.register("app", "2.0.0", "next-major")
            module = cl.load({"package": "app", "version": "^1.0.0"})
            assert module.fluid_export == "new" and module.version == "1.5.0"
            with pytest.raises(KeyError):
                cl.load({"package": "app", "version": "^3.0.0"})
            cl.register("app", "1.5.0", "replaced")
            again = cl.load({"package": "app"})
            return [module.fluid_export, module.version, again.version,
                    cl.load({"package": "app",
                             "version": "~1.5.0"}).fluid_export]
        same(script)


def code_loaded(s):
    server = s.local_server.LocalServer()
    code_loader = s.code_loader.CodeLoader()
    code_loader.register("notes-app", "1.0.0", make_runtime_factory(s))
    loader = s.Loader(
        s.local_driver.LocalDocumentServiceFactory(server),
        code_loader=code_loader,
        code_details={"package": "notes-app", "version": "^1.0.0"})
    return server, loader


class TestCodeLoadedContainer:
    def test_create_then_load_resolves_default_object(self):
        def script(s):
            server, loader = code_loaded(s)
            c1 = loader.create_detached("doc")
            obj1 = c1.request("/")
            assert obj1.root.get("title") == "untitled"
            c1.attach()
            obj1.root.set("title", "shared notes")
            c2 = loader.resolve("doc")
            obj2 = c2.request("/")
            assert obj2.root.get("title") == "shared notes"
            # Quorum carries the approved code details.
            assert c2.protocol.quorum.get("code")["package"] == "notes-app"
            return [obj2.root.get("title"), c2.protocol.quorum.get("code")]
        same(script)

    def test_code_upgrade_proposal_fires_event(self):
        def script(s):
            server, loader = code_loaded(s)
            c1 = loader.create_detached("doc")
            c1.attach()
            c2 = loader.resolve("doc")
            seen = []
            c2.on("codeChanged", seen.append)
            c1.propose_code_details({"package": "notes-app",
                                     "version": "^2.0.0"})
            # MSN must pass the proposal: BOTH clients must advance their
            # refSeq (an idle client pins the MSN).
            obj1, obj2 = c1.request("/"), c2.request("/")
            obj1.root.set("a", 1)
            obj2.root.set("b", 2)
            obj1.root.set("c", 3)
            assert seen and seen[0]["version"] == "^2.0.0"
            assert c2.protocol.quorum.get("code")["version"] == "^2.0.0"
            return seen
        same(script)


class TestBaseHost:
    def test_initialize_container_create_and_load(self):
        def script(s):
            server = s.local_server.LocalServer()
            cl = s.code_loader.CodeLoader()
            cl.register("notes-app", "1.0.0", make_runtime_factory(s))
            host = s.hosts.BaseHost(
                s.local_driver.LocalDocumentServiceFactory(server), cl,
                {"package": "notes-app"}, **s.device)
            obj = host.get_fluid_object("doc-1")
            obj.root.set("k", "v")
            # Second host (fresh loader) loads the same doc.
            host2 = s.hosts.BaseHost(
                s.local_driver.LocalDocumentServiceFactory(server), cl,
                {"package": "notes-app"}, **s.device)
            obj2 = host2.get_fluid_object("doc-1")
            assert obj2.root.get("k") == "v"
            reloaded = []
            container = host2.initialize_container("doc-1")
            host2.on_code_change(container, reloaded.append)
            container.emit("codeChanged", {"package": "notes-app"})
            assert len(reloaded) == 1 and \
                reloaded[0].request("/").root.get("k") == "v"
            return [obj2.root.get("k"), obj2.root.get("title")]
        same(script)


class TestDynamicAttach:
    def test_channel_created_live_replicates(self):
        def script(s):
            server = s.local_server.LocalServer()
            loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server))
            c1 = loader.create_detached("doc")
            ds1 = c1.runtime.create_datastore("default")
            ds1.create_channel("seed", s.map.SharedMap.TYPE)
            c1.attach()
            c2 = loader.resolve("doc")
            # Created AFTER both clients are live:
            m1 = ds1.create_channel("late", s.map.SharedMap.TYPE)
            m1.set("x", 42)
            m2 = c2.runtime.get_datastore("default").get_channel("late")
            assert m2.get("x") == 42
            m2.set("y", 7)
            assert m1.get("y") == 7
            return [sorted(m1.items()), sorted(m2.items())]
        same(script)

    def test_datastore_created_live_replicates(self):
        def script(s):
            server = s.local_server.LocalServer()
            loader = s.Loader(s.local_driver.LocalDocumentServiceFactory(
                server))
            c1 = loader.create_detached("doc")
            c1.runtime.create_datastore("default").create_channel(
                "seed", s.map.SharedMap.TYPE)
            c1.attach()
            c2 = loader.resolve("doc")
            ds_new = c1.runtime.create_datastore("extra")
            m1 = ds_new.create_channel("m", s.map.SharedMap.TYPE)
            m1.set("deep", {"n": 1})
            m2 = c2.runtime.get_datastore("extra").get_channel("m")
            assert m2.get("deep") == {"n": 1}
            return m2.get("deep")
        same(script)


class TestLegacyDocument:
    def test_create_and_load_roundtrip(self):
        def script(s):
            server = s.local_server.LocalServer()
            factory = s.local_driver.LocalDocumentServiceFactory(server)
            doc = s.client_api.Document.create("legacy-doc", factory,
                                               **s.device)
            root = doc.get_root()
            root.set("greeting", "hello")
            text = doc.create_string("story")
            text.insert_text(0, "once upon a time")
            doc2 = s.client_api.Document.load("legacy-doc", factory,
                                              **s.device)
            assert doc2.existing is True
            assert doc2.get_root().get("greeting") == "hello"
            t2 = doc2.get("story")
            assert t2.get_text() == "once upon a time"
            t2.insert_text(0, "and ")
            assert text.get_text() == "and once upon a time"
            assert doc.id == doc2.id == "legacy-doc"
            assert doc.client_id != doc2.client_id
            return [text.get_text(), doc2.get_root().get("greeting")]
        same(script)

    def test_typed_creators(self):
        def script(s):
            server = s.local_server.LocalServer()
            factory = s.local_driver.LocalDocumentServiceFactory(server)
            doc = s.client_api.Document.create("doc-x", factory, **s.device)
            counter = doc.create_counter("c")
            counter.increment(5)
            matrix = doc.create_matrix("m")
            matrix.insert_rows(0, 2)
            matrix.insert_cols(0, 2)
            matrix.set_cell(0, 0, "corner")
            nums = doc.create_number_sequence("n")
            nums.insert_range(0, [1, 2, 3])
            doc2 = s.client_api.Document.load("doc-x", factory, **s.device)
            assert doc2.get("c").value == 5
            assert doc2.get("m").get_cell(0, 0) == "corner"
            assert doc2.get("n").get_items() == [1, 2, 3]
            return [doc2.get("c").value, doc2.get("m").extract(),
                    doc2.get("n").get_items()]
        same(script)


def test_entry_points_default_to_the_card(monkeypatch):
    """BaseHost and Document build their Loader on the card unless told
    otherwise: without CUDA they raise; device="cpu" reaches every
    channel they open."""
    from fluidframework_tpu_torch.client_api import Document
    from fluidframework_tpu_torch.hosts import BaseHost
    from fluidframework_tpu_torch.loader.code_loader import CodeLoader
    from fluidframework_tpu_torch.loader.drivers.local import \
        LocalDocumentServiceFactory
    from fluidframework_tpu_torch.server.local_server import LocalServer

    factory = LocalDocumentServiceFactory(LocalServer())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: BaseHost(factory, CodeLoader()),
                 lambda: Document.create("d", factory),
                 lambda: Document.load("d", factory)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    host = BaseHost(factory, CodeLoader(), device="cpu")
    assert host.loader.device.type == "cpu"
    doc = Document.create("d", factory, device="cpu")
    assert doc.create_string("s").device.type == "cpu"
    assert Document.load("d", factory, device="cpu").get(
        "s").device.type == "cpu"
