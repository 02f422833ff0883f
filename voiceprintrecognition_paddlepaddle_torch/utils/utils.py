"""Config plumbing, command-line helpers and score utilities (copy of the
JAX package's ``utils/utils.py`` ``Dict`` / ``dict_to_object`` /
``add_arguments`` / ``print_arguments`` / ``cal_accuracy_threshold`` /
``cal_accuracy`` / ``cosin_metric``)."""

import argparse

import numpy as np

from .logger import logger

__all__ = ["Dict", "dict_to_object", "add_arguments", "print_arguments",
           "cal_accuracy_threshold", "cal_accuracy", "cosin_metric"]


class Dict(dict):
    """dict with attribute access (reference ``utils/utils.py:41-44``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def dict_to_object(dict_obj):
    """Recursively convert plain dicts to attribute-dicts
    (reference ``utils/utils.py:47-52``)."""
    if not isinstance(dict_obj, dict):
        return dict_obj
    inst = Dict()
    for k, v in dict_obj.items():
        inst[k] = dict_to_object(v)
    return inst


def print_arguments(args=None, configs=None, title=None):
    """Echo argparse args and/or nested config dicts to the log
    (reference ``utils/utils.py:8-29``)."""
    if args:
        logger.info("----------- extra arguments -----------")
        for arg, value in sorted(vars(args).items()):
            logger.info(f"{arg}: {value}")
        logger.info("----------------------------------------")
    if configs:
        title = title or "config parameters"
        logger.info(f"----------- {title} -----------")

        def _print(d, indent=0):
            for k, v in sorted(d.items(), key=lambda kv: str(kv[0])):
                if isinstance(v, dict):
                    logger.info("\t" * indent + f"{k}:")
                    _print(v, indent + 1)
                else:
                    logger.info("\t" * indent + f"{k}: {v}")

        _print(configs)
        logger.info("----------------------------------------")


def _strtobool(v):
    v = str(v).lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise argparse.ArgumentTypeError(f"invalid bool value {v!r}")


def add_arguments(argname, type, default, help, argparser, **kwargs):
    """argparse helper with bool coercion (reference ``utils/utils.py:32-38``)."""
    type = _strtobool if type == bool else type
    argparser.add_argument("--" + argname,
                           default=default,
                           type=type,
                           help=help + " Default: %(default)s.",
                           **kwargs)


def cal_accuracy_threshold(y_score, y_true):
    """Scan thresholds 0.00..0.99 for the best accuracy
    (reference ``utils/utils.py`` cal_accuracy_threshold), vectorised."""
    y_score = np.asarray(y_score, dtype=np.float32)
    y_true = np.asarray(y_true)
    thresholds = np.arange(100, dtype=np.float32) * 0.01
    # (100, N) >= comparison in one shot
    preds = y_score[None, :] >= thresholds[:, None]
    accs = (preds == y_true[None, :].astype(bool)).mean(axis=1)
    best = int(np.argmax(accs))
    return float(accs[best]), float(thresholds[best])


def cal_accuracy(y_score, y_true, threshold=0.5):
    """Accuracy of (score >= threshold) against binary labels
    (reference ``utils/utils.py`` cal_accuracy)."""
    y_score = np.asarray(y_score)
    y_true = np.asarray(y_true)
    return float(((y_score >= threshold) == y_true.astype(bool)).mean())


def cosin_metric(x1, x2):
    """Cosine similarity of two vectors (reference ``utils/utils.py`` cosin_metric)."""
    return float(np.dot(x1, x2) / (np.linalg.norm(x1) * np.linalg.norm(x2)))
