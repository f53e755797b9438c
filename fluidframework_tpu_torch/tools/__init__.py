"""Operator and offline tools (reference layer 8: packages/tools): the
micro-perf harness (microbench.py), the on-card kernel conformance check
(gpu_conformance.py), and the offline document tools ported from
fluidframework_tpu's tools/: the fetch tool, the replay tool and the
merge-tree client replay."""

from .fetch_tool import FetchStats, fetch_document
from .mergetree_replay import MergeTreeReplayer
from .replay_tool import ReplayArgs, ReplayResult, ReplayTool
