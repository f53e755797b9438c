"""View layer: uniform render adapters + reactive state bindings.

Capability parity with reference packages/framework/{view-interfaces,
view-adapters, react}: the reference defines IFluidHTMLView /
IFluidMountableView (feature-detected render surfaces), HTMLViewAdapter /
MountableView (wrap *any* view-providing object uniformly and keep it
mounted across host moves), and the react bindings (useStateFluid /
SyncedDataObject — local view state two-way-synced with DDS state).

There is no DOM here; the render target is a host-provided sink callable.
The contracts are preserved: feature detection over duck-typed
`render()` / `IFluidRenderable`, adapter-managed subscriptions with
re-render on every remote or local change, and `use_synced_state` —
a (value, setter) pair bound to a SharedMap key that re-renders observers
on convergence, the functional-react analog.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

# DDS change events an adapter watches (per-type; feature-detected).
_CHANGE_EVENTS = ("valueChanged", "sequenceDelta", "clear", "cellChanged",
                  "incremented", "containedValueChanged")


class IFluidRenderable:
    """Marker base: objects with a `render() -> Any` view surface
    (reference IFluidHTMLView.render)."""

    def render(self) -> Any:
        raise NotImplementedError


def get_renderable(obj: Any) -> Optional[Callable[[], Any]]:
    """Feature detection (reference IProvide pattern): an object offers a
    view if it implements render(), or exposes one via `IFluidRenderable`."""
    provided = getattr(obj, "IFluidRenderable", None)
    if provided is not None and provided is not obj:
        return get_renderable(provided)
    render = getattr(obj, "render", None)
    return render if callable(render) else None


class ViewAdapter:
    """Wraps any view-providing data object; keeps a host sink updated
    (reference HTMLViewAdapter: probes the object's view capability and
    re-renders into the element on every change)."""

    def __init__(self, obj: Any):
        self.render_fn = get_renderable(obj)
        if self.render_fn is None:
            raise TypeError(f"{type(obj).__name__} provides no view surface")
        self.obj = obj
        self.sink: Optional[Callable[[Any], None]] = None
        self._subscribed: List[Any] = []

    # -- mount lifecycle (IFluidMountableView mount/unmount) ---------------
    def mount(self, sink: Callable[[Any], None]) -> None:
        self.sink = sink
        self._subscribe()
        self.refresh()

    def unmount(self) -> None:
        self.sink = None
        # Subscriptions stay (events are cheap); a remount reuses them.

    def refresh(self) -> None:
        if self.sink is not None:
            self.sink(self.render_fn())

    def _subscribe(self) -> None:
        """Watch the object's channels for changes (the adapter analog of
        DOM re-render on DDS events)."""
        if self._subscribed:
            return
        channels = []
        root = getattr(self.obj, "root", None)
        if root is not None:
            channels.append(root)
        runtime = getattr(self.obj, "runtime", None)
        if runtime is not None and hasattr(runtime, "channels"):
            channels.extend(runtime.channels.values())
        store = getattr(self.obj, "store", None)
        if store is not None and hasattr(store, "channels"):
            channels.extend(store.channels.values())
        for channel in channels:
            if channel in self._subscribed:
                continue
            for event in _CHANGE_EVENTS:
                channel.on(event, self._on_change)
            self._subscribed.append(channel)

    def _on_change(self, *args) -> None:
        self.refresh()


class MountableView:
    """Transferable mount wrapper (reference MountableView): created once,
    mounted/unmounted/remounted across host surfaces without rebuilding the
    adapter."""

    def __init__(self, obj: Any):
        self.adapter = ViewAdapter(obj)
        self.mounted_at: Optional[str] = None

    def mount(self, surface_id: str, sink: Callable[[Any], None]) -> None:
        if self.mounted_at is not None:
            raise RuntimeError(f"already mounted at {self.mounted_at}")
        self.mounted_at = surface_id
        self.adapter.mount(sink)

    def unmount(self) -> None:
        self.mounted_at = None
        self.adapter.unmount()


def use_synced_state(shared_map, key: str, default: Any = None,
                     on_change: Optional[Callable[[Any], None]] = None
                     ) -> Tuple[Callable[[], Any], Callable[[Any], None]]:
    """Functional state binding (reference useStateFluid): returns
    (get_value, set_value) where set writes through to the DDS and
    `on_change(new_value)` fires for every local or remote update of the
    key — the setState re-render signal."""
    if on_change is not None:
        def _watch(changed_key, local, previous):
            if changed_key == key:
                on_change(shared_map.get(key, default))
        shared_map.on("valueChanged", _watch)

    def get_value():
        return shared_map.get(key, default)

    def set_value(value):
        shared_map.set(key, value)

    return get_value, set_value


class SyncedDataObject:
    """Reference react/syncedDataObject.ts: a data object whose declared
    state keys live in its root directory and surface as synced bindings."""

    def __init__(self, data_object, config: Dict[str, Any]):
        from ..dds.directory import SharedDirectory
        self.data_object = data_object
        self.config = dict(config)
        self._listeners: List[Callable[[str, Any], None]] = []
        # Directory valueChanged carries (path, key, local); map carries
        # (key, local, previous).
        self._root_is_dir = isinstance(data_object.root, SharedDirectory)
        data_object.root.on("valueChanged", self._on_value)

    def _on_value(self, *args) -> None:
        key = args[1] if self._root_is_dir else args[0]
        if key in self.config:
            for fn in self._listeners:
                fn(key, self.get(key))

    def on_state_change(self, fn: Callable[[str, Any], None]) -> None:
        self._listeners.append(fn)

    def get(self, key: str) -> Any:
        return self.data_object.root.get(key, self.config.get(key))

    def set(self, key: str, value: Any) -> None:
        if key not in self.config:
            raise KeyError(f"undeclared synced state key {key!r}")
        self.data_object.root.set(key, value)
