"""A YAML reader for the subset that ``configs/*.yml`` use, so that every
entry point starts from a config path on hosts without PyYAML.

The subset: nested block mappings, block lists of ``- `` items (at the
key's indent or deeper), flow lists ``[...]`` on one line, the empty
mapping ``{}``, ``#`` comments, and scalars resolved as
``yaml.safe_load`` resolves them (YAML 1.1): decimal ints, floats with a
dot (``1.0e-06``; ``1e-6`` stays a string, as in PyYAML), ``.inf`` and
``.nan``, the YAML 1.1 bools (``true``, ``yes``, ``on`` and their cases),
nulls (``null``, ``~``, empty), and single- or double-quoted strings.

Anything else raises ``ValueError`` naming the line: anchors, aliases,
tags, block scalars (``|``, ``>``), multi-line plain scalars, documents
(``---``), flow lists over several lines, other flow mappings, mappings
inside list items, tabs in the indentation, duplicate keys, and the
scalars YAML 1.1 reads as octal, hex, binary, sexagesimal numbers or
timestamps.
"""

import re

__all__ = ["load_yaml", "parse_yaml"]

_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
# what YAML 1.1 reads as a number or a date in a form this reader leaves out
_OTHER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no, indent, text):
        self.no, self.indent, self.text = no, indent, text


def _error(no, msg):
    return ValueError(f"line {no}: {msg}")


def _strip_comment(text, no):
    """``text`` without a ``#`` comment (one at the start or after a
    space, outside quotes)."""
    quote, i = None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote and quote == "'" and text[i + 1:i + 2] == "'":
                i += 1          # '' inside single quotes
            elif c == quote:
                quote = None
            elif c == "\\" and quote == '"':
                i += 1          # an escaped character
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        raise _error(no, "unterminated quoted string")
    return text.rstrip()


def _quoted(text, no):
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise _error(no, f"unsupported quoted scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise _error(no, f"unsupported quoted scalar {text!r}")
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == '"':
            raise _error(no, f"unsupported quoted scalar {text!r}")
        if c == "\\":
            if i + 1 >= len(body) or body[i + 1] not in _ESCAPES:
                raise _error(no, f"unsupported escape in {text!r}")
            out.append(_ESCAPES[body[i + 1]])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _scalar(text, no):
    """A plain or quoted scalar, resolved as ``yaml.safe_load`` does."""
    if text[:1] in ("'", '"'):
        return _quoted(text, no)
    if text[:1] in tuple("&*!|>%@`{}]") or text.startswith(("? ", "- ")) \
            or text in ("?", "-", "---", "..."):
        raise _error(no, f"unsupported construct {text!r}")
    if ": " in text or text.endswith(":"):
        raise _error(no, f"unsupported plain scalar {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    if _OTHER.match(text):
        raise _error(no, f"scalar {text!r} is a YAML 1.1 number or date in "
                         f"a form this reader does not take")
    return text


def _flow(text, no):
    """A flow list ``[...]`` of scalars and flow lists, or ``{}``."""
    if text.replace(" ", "") == "{}":
        return {}
    value, end = _flow_list(text, 0, no)
    if text[end:].strip():
        raise _error(no, f"unsupported flow collection {text!r}")
    return value


def _skip(text, i):
    while i < len(text) and text[i] == " ":
        i += 1
    return i


def _flow_list(text, i, no):
    """The flow list that opens at ``text[i]`` -> (list, index after)."""
    if text[i:i + 1] != "[":
        raise _error(no, f"unsupported flow collection {text!r}")
    out, i = [], i + 1
    while True:
        i = _skip(text, i)
        c = text[i:i + 1]
        if c == "]":
            return out, i + 1
        if c == "[":
            value, i = _flow_list(text, i, no)
        elif c in ("'", '"'):
            j = i + 1
            while j < len(text) and not (text[j] == c and not (
                    c == "'" and text[j + 1:j + 2] == "'")):
                j += 2 if text[j] == "\\" and c == '"' or \
                    text[j:j + 2] == "''" else 1
            value, i = _quoted(text[i:j + 1], no), j + 1
        elif c in ("", ",", "{", "}"):
            raise _error(no, f"unsupported flow list {text!r}")
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                j += 1
            value, i = _scalar(text[i:j].strip(), no), j
        out.append(value)
        i = _skip(text, i)
        if text[i:i + 1] == ",":
            i += 1
        elif text[i:i + 1] != "]":
            raise _error(no, f"unbalanced flow list {text!r}")


def _value(text, no):
    return _flow(text, no) if text[:1] in "[{" else _scalar(text, no)


def _split_key(text, no):
    """``key: value`` -> (key, value text); None if the line is no
    mapping entry."""
    if text[:1] in ("'", '"'):
        end = text.find(text[0], 1)
        while text[0] == "'" and end != -1 and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1 or text[end + 1:end + 2] != ":":
            return None
        key, rest = _quoted(text[:end + 1], no), text[end + 2:]
    else:
        m = re.search(r":(?:\s|$)", text)
        if m is None:
            return None
        key, rest = text[:m.start()], text[m.start() + 1:]
        if key.startswith(("[", "{")):
            return None     # a flow collection, not a key
        if not key or key.startswith("? "):
            raise _error(no, f"unsupported mapping key {key!r}")
        key = _scalar(key, no)
    if rest and not rest[0].isspace():
        return None
    return key, rest.strip()


def _is_item(line):
    return line.text == "-" or line.text.startswith("- ")


class _Parser:
    def __init__(self, lines):
        self.lines, self.i = lines, 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self):
        line = self.peek()
        if _is_item(line):
            return self.seq(line.indent)
        return self.mapping(line.indent)

    def nested(self, parent):
        """The block value of a key or item on line ``parent`` whose
        inline text is empty; a list may sit at the key's indent."""
        line = self.peek()
        if line is not None and (line.indent > parent.indent or (
                line.indent == parent.indent and _is_item(line)
                and not _is_item(parent))):
            return self.block()
        return None

    def mapping(self, indent):
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            if _is_item(line):
                return out  # a list at the key's indent ends the mapping
            kv = _split_key(line.text, line.no)
            if kv is None:
                raise _error(line.no, f"expected 'key: value', got "
                                      f"{line.text!r}")
            key, rest = kv
            if key in out:
                raise _error(line.no, f"duplicate key {key!r}")
            self.i += 1
            out[key] = self.nested(line) if rest == "" else _value(rest,
                                                                   line.no)
            after = self.peek()
            if rest and after is not None and after.indent > indent:
                raise _error(after.no, "unsupported multi-line value")

    def seq(self, indent):
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            if not _is_item(line):
                return out
            rest = line.text[1:].strip()
            self.i += 1
            if rest == "":
                out.append(self.nested(line))
            elif _split_key(rest, line.no) is not None:
                raise _error(line.no, "unsupported mapping inside a list item")
            else:
                out.append(_value(rest, line.no))
                after = self.peek()
                if after is not None and after.indent > indent:
                    raise _error(after.no, "unsupported multi-line value")


def parse_yaml(text):
    """``text`` -> the Python value ``yaml.safe_load`` gives (dicts,
    lists, scalars); None for an empty document."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise _error(no, "tab in indentation")
        body = _strip_comment(body, no)
        if not body:
            continue
        if body.startswith(("---", "...", "%")):
            raise _error(no, f"unsupported document marker {body!r}")
        lines.append(_Line(no, len(raw) - len(raw.lstrip(" ")), body))
    if not lines:
        return None
    parser = _Parser(lines)
    first = lines[0]
    if first.indent == 0 and not _is_item(first) \
            and _split_key(first.text, first.no) is None:
        out = _value(first.text, first.no)
        parser.i = 1
    else:
        out = parser.block()
    left = parser.peek()
    if left is not None:
        raise _error(left.no, "unexpected indentation")
    return out


def load_yaml(path):
    """Read a YAML config file (the subset above)."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_yaml(f.read())
