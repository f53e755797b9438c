"""Host layer (reference layer 8: packages/hosts); a port of
fluidframework_tpu's hosts/."""

from .base_host import BaseHost
