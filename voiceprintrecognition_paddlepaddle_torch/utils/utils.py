"""Config plumbing: nested dicts with attribute access (copy of the JAX
package's ``utils/utils.py`` ``Dict`` / ``dict_to_object``)."""

__all__ = ["Dict", "dict_to_object"]


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
