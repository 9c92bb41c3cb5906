"""Evaluation metrics (reference ``controller/Metric.scala``, UNVERIFIED path).

The port's copy of ``pio_tpu/controller/metrics.py`` (the port imports
nothing of ``pio_tpu``). A Metric folds the evaluation data set —
``[(eval_info, [(q, p, a)])]`` — into one comparable result, on the host:
the algorithms' batch scoring has already run on the device.
"""

from __future__ import annotations

import abc
import math
from typing import Generic, Optional, Sequence, Tuple, TypeVar

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

#: one fold: (eval_info, [(query, prediction, actual)])
EvalDataSet = Sequence[Tuple[EI, Sequence[Tuple[Q, P, A]]]]


class Metric(abc.ABC, Generic[EI, Q, P, A]):
    """Base metric; higher is better unless ``higher_is_better`` says not."""

    higher_is_better: bool = True

    @abc.abstractmethod
    def calculate(self, eval_data_set: EvalDataSet) -> float: ...

    @property
    def header(self) -> str:
        return type(self).__name__

    def compare(self, r0: float, r1: float) -> int:
        """sign(r0 - r1) respecting direction (reference ``Metric.compare``)."""
        delta = (r0 - r1) if self.higher_is_better else (r1 - r0)
        return (delta > 0) - (delta < 0)


class AverageMetric(Metric[EI, Q, P, A]):
    """Mean of a per-(Q,P,A) score over all folds (reference ``AverageMetric``)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, prediction: P, actual: A) -> float: ...

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        total, n = 0.0, 0
        for _, qpa in eval_data_set:
            for q, p, a in qpa:
                total += self.calculate_one(q, p, a)
                n += 1
        return total / n if n else float("nan")


class OptionAverageMetric(Metric[EI, Q, P, A]):
    """Like AverageMetric but ``None`` scores are excluded from the mean
    (reference ``OptionAverageMetric``)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, prediction: P, actual: A) -> Optional[float]: ...

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        total, n = 0.0, 0
        for _, qpa in eval_data_set:
            for q, p, a in qpa:
                s = self.calculate_one(q, p, a)
                if s is not None:
                    total += s
                    n += 1
        return total / n if n else float("nan")


class SumMetric(Metric[EI, Q, P, A]):
    """Sum of per-(Q,P,A) scores (reference ``SumMetric``)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, prediction: P, actual: A) -> float: ...

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return sum(
            self.calculate_one(q, p, a)
            for _, qpa in eval_data_set
            for q, p, a in qpa
        )


class StdevMetric(Metric[EI, Q, P, A]):
    """Population stdev of per-(Q,P,A) scores (reference ``StdevMetric``)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, prediction: P, actual: A) -> float: ...

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        xs = [
            self.calculate_one(q, p, a)
            for _, qpa in eval_data_set
            for q, p, a in qpa
        ]
        if not xs:
            return float("nan")
        mean = sum(xs) / len(xs)
        return math.sqrt(sum((x - mean) ** 2 for x in xs) / len(xs))


class ZeroMetric(Metric[EI, Q, P, A]):
    """Always 0 — placeholder (reference ``ZeroMetric``)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return 0.0
