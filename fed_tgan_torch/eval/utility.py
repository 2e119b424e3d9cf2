"""ML utility: train on synthetic rows, test on real ones (counterpart of
``fed_tgan_tpu/eval/utility.py``, the reference's ``utility_analysis.py``),
without pandas.

Tables are ``{name: column}`` as :func:`~fed_tgan_torch.data.csvio.read_csv`
returns them.  The protocol is the reference's, with sklearn's own
estimators, so the numbers are sklearn's:

- every categorical column is label-encoded (sklearn's ``LabelEncoder``)
  on the string form of real train ∪ real test, each cell as pandas'
  ``astype(str)`` spells it;
- the target is dropped from the features, and a ``StandardScaler`` is
  fitted on the reference table's float64 matrix, columns in table order;
- logistic regression, a decision tree, a random forest (each with
  ``class_weight="balanced"``) and an MLP at ``random_state=69`` report
  accuracy and weighted F1; a ``ConvergenceWarning`` is silenced, since the
  reference runs these estimators at their defaults.

sklearn is imported where it is used: without it :func:`ml_utility`
raises ``ImportError`` naming it, and the module CLI exits 2 (``python -m
fed_tgan_torch.eval.utility --real-train T.csv --real-test V.csv
--synthetic S.csv --target Y [--categorical ...] [--json]``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from fed_tgan_torch.data.csvio import cell_strings

RANDOM_STATE = 69
MODELS = ("LR", "DT", "RF", "MLP")


def _sklearn():
    try:
        import sklearn  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "the ML-utility evaluation (fed_tgan_torch.eval.utility) needs "
            "sklearn, which does not import here") from exc


def _labels(values) -> np.ndarray:
    """pandas' ``astype(str)`` of a column as the object array sklearn
    receives: strings, a missing cell NaN."""
    return np.array([float("nan") if s is None else s
                     for s in cell_strings(values).tolist()], dtype=object)


def _concat(a: dict, b: dict) -> dict:
    """``pd.concat([a, b])`` of two tables with ``a``'s columns."""
    return {c: np.concatenate([np.asarray(a[c]), np.asarray(b[c])])
            for c in a}


def ml_utility(reference: dict, train: dict, test: dict, target_column: str,
               categorical_columns: Sequence[str]) -> list[list[float]]:
    """``[[accuracy, weighted F1] for LR, DT, RF, MLP]`` trained on
    ``train`` and tested on ``test``; the encoders and the scaler are
    fitted on ``reference`` (real train ∪ real test)."""
    _sklearn()
    import warnings

    from sklearn import ensemble, linear_model, metrics, preprocessing, tree
    from sklearn.exceptions import ConvergenceWarning
    from sklearn.neural_network import MLPClassifier

    tables = [dict(reference), dict(train), dict(test)]
    for col in categorical_columns:
        labels = [_labels(t[col]) for t in tables]
        le = preprocessing.LabelEncoder().fit(labels[0])
        for t, lab in zip(tables, labels):
            t[col] = le.transform(lab)
    ref, train, test = tables
    features = [c for c in ref if c != target_column]

    def matrix(t):
        return np.stack([np.asarray(t[c], dtype=np.float64)
                         for c in features], axis=1)

    scaler = preprocessing.StandardScaler().fit(matrix(ref))
    x_train, x_test = scaler.transform(matrix(train)), scaler.transform(
        matrix(test))
    y_train, y_test = train[target_column], test[target_column]
    models = [
        linear_model.LogisticRegression(class_weight="balanced",
                                        random_state=RANDOM_STATE),
        tree.DecisionTreeClassifier(class_weight="balanced",
                                    random_state=RANDOM_STATE),
        ensemble.RandomForestClassifier(class_weight="balanced",
                                        random_state=RANDOM_STATE),
        MLPClassifier(random_state=RANDOM_STATE),
    ]
    out = []
    for model in models:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ConvergenceWarning)
            model.fit(x_train, y_train)
        pred = model.predict(x_test)
        out.append([float(metrics.accuracy_score(y_test, pred)),
                    float(metrics.f1_score(y_test, pred, average="weighted"))])
    return out


def utility_difference(real_train: dict, synthetic: dict, test: dict,
                       target_column: str,
                       categorical_columns: Sequence[str]) -> dict:
    """The real-minus-synthetic utility gap (``real``, ``synthetic``,
    ``difference`` per model, and their means ``delta_accuracy`` and
    ``delta_f1``)."""
    reference = _concat(real_train, test)
    real_u = np.asarray(ml_utility(reference, real_train, test,
                                   target_column, categorical_columns))
    fake_u = np.asarray(ml_utility(reference, synthetic, test,
                                   target_column, categorical_columns))
    diff = real_u - fake_u
    return {
        "real": real_u.tolist(),
        "synthetic": fake_u.tolist(),
        "difference": diff.tolist(),
        "delta_accuracy": float(diff.mean(axis=0)[0]),
        "delta_f1": float(diff.mean(axis=0)[1]),
    }


def _main(argv=None) -> int:
    """The train-on-synthetic, test-on-real gap over three CSVs
    (``fed_tgan_tpu/eval/utility.py:114-147``); exit 2 without sklearn."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        description="ML-utility gap (LR/DT/RF/MLP acc+F1, real minus "
                    "synthetic)")
    p.add_argument("--real-train", required=True)
    p.add_argument("--real-test", required=True)
    p.add_argument("--synthetic", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--categorical", nargs="*", default=[])
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    args = p.parse_args(argv)
    try:
        _sklearn()
    except ImportError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    from fed_tgan_torch.data.csvio import read_csv

    train = read_csv(args.real_train)
    test = read_csv(args.real_test)
    fake = read_csv(args.synthetic)
    fake = {c: fake[c] for c in train}
    res = utility_difference(train, fake, test, args.target,
                             args.categorical)
    if args.json:
        print(json.dumps(res))
        return 0
    print(f"{'model':<6} {'real acc':>9} {'real F1':>8} {'syn acc':>8} "
          f"{'syn F1':>7}")
    for i, m in enumerate(MODELS):
        ra, rf = res["real"][i]
        sa, sf = res["synthetic"][i]
        print(f"{m:<6} {ra:>9.4f} {rf:>8.4f} {sa:>8.4f} {sf:>7.4f}")
    print(f"delta_accuracy={res['delta_accuracy']:.6f} "
          f"delta_f1={res['delta_f1']:.6f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
