"""Agents layer (reference packages/agents + server/headless-agent)."""

from .headless import HeadlessAgentRunner
from .intelligence import (IntelligenceRunner, key_phrases, sentiment,
                           text_analytics)
