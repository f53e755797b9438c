"""Framework layer: aqueduct data objects, runtime factories, undo-redo,
interceptions, agent scheduler, DI, request routing.

Parity: reference packages/framework/* (SURVEY.md §2.4). A port of
fluidframework_tpu's framework/: host only; a data object's channels run
on the device of the container runtime it lives in."""

from .agent_scheduler import AgentScheduler
from .container_factories import (
    BaseContainerRuntimeFactory,
    ContainerRuntimeFactoryWithDefaultDataStore,
)
from .data_object import DataObject, DataObjectFactory, PureDataObject
from .last_edited import (LastEditedTracker, setup_last_edited_tracking)
from .lazy_data_object import (LazyLoadedDataObject,
                               LazyLoadedDataObjectFactory)
from .views import (MountableView, SyncedDataObject, ViewAdapter,
                    use_synced_state)
from .interceptions import (
    create_shared_map_with_interception,
    create_shared_string_with_interception,
)
from .request_handler import (
    RequestHandlerChain,
    RequestParser,
    datastore_route_handler,
)
from .synthesize import DependencyContainer
from .undo_redo import (
    SharedMapUndoRedoHandler,
    SharedMatrixUndoRedoHandler,
    SharedSegmentSequenceUndoRedoHandler,
    UndoRedoStackManager,
)

__all__ = [
    "AgentScheduler",
    "BaseContainerRuntimeFactory",
    "ContainerRuntimeFactoryWithDefaultDataStore",
    "DataObject", "DataObjectFactory", "PureDataObject",
    "create_shared_map_with_interception",
    "create_shared_string_with_interception",
    "RequestHandlerChain", "RequestParser", "datastore_route_handler",
    "DependencyContainer",
    "SharedMapUndoRedoHandler", "SharedMatrixUndoRedoHandler",
    "SharedSegmentSequenceUndoRedoHandler", "UndoRedoStackManager",
    "LastEditedTracker", "setup_last_edited_tracking",
    "LazyLoadedDataObject", "LazyLoadedDataObjectFactory",
    "MountableView", "SyncedDataObject", "ViewAdapter", "use_synced_state",
]
