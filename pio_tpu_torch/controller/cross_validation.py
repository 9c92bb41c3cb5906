"""K-fold cross-validation split — rebuild of the reference's e2 eval helper.

The port's copy of ``pio_tpu/controller/cross_validation.py`` (the port
imports nothing of ``pio_tpu``).

Reference: ``e2/src/main/scala/o/a/p/e2/evaluation/CommonHelperFunctions.scala``
(``splitData``; UNVERIFIED path, see SURVEY.md §2.5): split an indexed dataset
into k folds, where fold i's test set is every element whose index ≡ i (mod k)
and its training set is everything else — then hand both to user-supplied
constructors.

Used by template ``read_eval`` implementations to produce the
``[(training_data, eval_info, [(query, actual)])]`` folds the Evaluation
framework consumes.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
    k: int,
    data: Sequence[D],
    to_training_data: Callable[[List[D]], TD],
    to_query_actual: Callable[[D], Tuple[Q, A]],
) -> List[Tuple[TD, dict, List[Tuple[Q, A]]]]:
    """Deterministic k-fold split by element index.

    Returns one ``(training_data, eval_info, [(query, actual)])`` triple per
    fold; ``eval_info`` is ``{"fold": i}``.
    """
    if k <= 1:
        raise ValueError("k-fold cross-validation needs k >= 2")
    folds = []
    for fold in range(k):
        train = [d for i, d in enumerate(data) if i % k != fold]
        test = [d for i, d in enumerate(data) if i % k == fold]
        folds.append(
            (
                to_training_data(train),
                {"fold": fold},
                [to_query_actual(d) for d in test],
            )
        )
    return folds
