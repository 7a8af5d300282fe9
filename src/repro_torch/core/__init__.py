"""HASCO core: TST IR, two-step tensorize matching, HW/SW design spaces,
cost model, MOBO / NSGA-II / random hardware DSE, heuristic + Q-learning (PyTorch DQN) software
DSE, and the co-design driver (paper Fig. 3)."""

from .codesign import Constraints, Solution, codesign, separate_design
from .cost_model import (CostReport, EvalCache, evaluate, evaluate_batch,
                         evaluate_batch_reports)
from .hw_primitives import HWBuilder, HWConfig
from .hw_space import HWSpace
from .intrinsics import ALL_INTRINSICS
from .matching import TensorizeChoice, match, partition_space
from .mobo import mobo
from .nsga2 import nsga2
from .random_search import random_search
from .sw_dse import SearchSpec, SWResult, run_searches
from .sw_primitives import Schedule
from .tst import TensorExpr, parse

__all__ = [
    "ALL_INTRINSICS", "Constraints", "CostReport", "EvalCache", "HWBuilder",
    "HWConfig", "HWSpace", "SWResult", "Schedule", "SearchSpec", "Solution",
    "TensorExpr", "TensorizeChoice", "codesign", "evaluate",
    "evaluate_batch", "evaluate_batch_reports", "match", "mobo", "nsga2",
    "parse", "partition_space", "random_search", "run_searches",
    "separate_design",
]
