"""A reader and writer for the YAML subset that dataset and model files use.

The port reads no third-party YAML library (the card's machine has none), so
this covers what `edgeyolo_tpu/cfg/datasets/*.yaml`, `default.yaml` and the
synthetic generator's `dataset.yaml` hold:

- `key: value` scalars and nested block mappings, by indentation;
- block lists (`- item`, also `- key: value` items) and flow lists and
  mappings (`[a, 'b c']`, `{k: v}`), which may span lines;
- single- and double-quoted strings, `#` comments;
- `|` and `>` block scalars, kept as text.

Plain scalars resolve as YAML 1.1 does for `yaml.safe_load`: null (`~`,
`null`, empty), booleans (`true`, `yes`, `on`, ... in their three cases),
integers (decimal, 0x, 0b, octal 0..., underscores) and floats (with a dot or an
exponent, `.inf`, `.nan`); anything else is a string. Anchors, tags and
multiple documents are not supported and raise.
"""

from __future__ import annotations

import re
from pathlib import Path

_BOOL = {v: True for w in ("yes", "true", "on", "y") for v in (w, w.capitalize(), w.upper())}
_BOOL.update({v: False for w in ("no", "false", "off", "n") for v in
              (w, w.capitalize(), w.upper())})
for _k in ("y", "Y", "n", "N"):  # safe_load reads these as strings
    _BOOL.pop(_k, None)
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_INT_BASE = re.compile(r"^[-+]?0(x[0-9a-fA-F_]+|[0-7_]+|b[01_]+)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|^[-+]?[0-9][0-9_]*(\.[0-9_]*)?[eE][-+][0-9]+$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")


def _scalar(s: str):
    """A plain scalar's value under YAML 1.1's resolvers."""
    s = s.strip()
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _INT_BASE.match(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t[1] in "xX":
            return sign * int(t[2:], 16)
        if t[1] in "bB":
            return sign * int(t[2:], 2)
        return sign * int(t[1:], 8)
    if _FLOAT.match(s) and s not in (".", "+.", "-."):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a `#` at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(s: str, i: int) -> tuple[str, int]:
    """The quoted string starting at s[i]; returns (value, index after it)."""
    q = s[i]
    out, j = [], i + 1
    while j < len(s):
        ch = s[j]
        if q == "'" and ch == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            nxt = s[j + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0",
                        "r": "\r"}.get(nxt, "\\" + nxt))
            j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"unterminated string in {s!r}")


def _flow(s: str, i: int = 0):
    """Parse a flow node at s[i] ([...], {...}, a quoted or a plain scalar);
    returns (value, index after it)."""
    while s[i] in " \t\n":
        i += 1
    if s[i] in "[{":
        close = "]" if s[i] == "[" else "}"
        seq, mapping, i = [], {}, i + 1
        while True:
            while s[i] in " \t\n,":
                i += 1
            if s[i] == close:
                return (seq if close == "]" else mapping), i + 1
            key, i = _flow(s, i)
            while s[i] in " \t\n":
                i += 1
            if close == "}" or s[i] == ":":
                if s[i] != ":":
                    raise ValueError(f"expected ':' in flow mapping {s!r}")
                val, i = _flow(s, i + 1)
                if close == "]":
                    seq.append({key: val})
                else:
                    mapping[key] = val
            else:
                seq.append(key)
    if s[i] in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ",]}" and not (s[j] == ":" and s[j + 1:j + 2] in (" ", "")):
        j += 1
    return _scalar(s[i:j]), j


def _value(text: str):
    """An inline value: flow collection, quoted string or plain scalar."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "[{'\"":
        val, end = _flow(text + " ")
        if text[end:].strip():
            raise ValueError(f"trailing text after {text[:end]!r}")
        return val
    if text[0] in "&*!":
        raise ValueError(f"YAML anchors, aliases and tags are not supported: {text!r}")
    return _scalar(text)


def _split_key(content: str):
    """'key: rest' -> (key, rest), or None when the line is not a mapping entry."""
    if content[0] in "'\"":
        key, j = _quoted(content, 0)
        rest = content[j:].lstrip()
        return (key, rest[1:]) if rest.startswith(":") else None
    m = re.match(r"^([^\[\]{},#][^#]*?)\s*:(\s+|$)", content)
    if not m:
        return None
    return _scalar(m.group(1)), content[m.end():]


class _Parser:
    def __init__(self, text: str):
        self.lines = []  # (indent, content, raw line)
        for raw in text.splitlines():
            content = _strip_comment(raw)
            if raw.strip() in ("---", "...") or raw.startswith("%"):
                if self.lines and raw.strip() == "---":
                    raise ValueError("multiple YAML documents are not supported")
                continue
            self.lines.append((len(raw) - len(raw.lstrip(" ")), content.strip(), raw))
        self.i = 0

    def _skip_blank(self):
        while self.i < len(self.lines) and not self.lines[self.i][1]:
            self.i += 1

    def parse(self):
        self._skip_blank()
        if self.i >= len(self.lines):
            return None
        return self._node(self.lines[self.i][0])

    def _node(self, indent: int):
        self._skip_blank()
        ind, content, _ = self.lines[self.i]
        if content.startswith("- ") or content == "-":
            return self._seq(ind)
        if _split_key(content) is not None:
            return self._map(ind)
        self.i += 1
        return self._inline(content, ind)

    def _inline(self, text: str, indent: int):
        """A value that starts on the current line; a flow collection left open
        takes the following lines, a block scalar its indented block."""
        text = text.strip()
        if text[:1] in ("|", ">"):
            return self._block_scalar(text, indent)
        if text[:1] in "[{":
            depth = lambda t: sum(t.count(c) for c in "[{") - sum(t.count(c) for c in "]}")
            while depth(text) > 0 and self.i < len(self.lines):
                text += " " + self.lines[self.i][1]
                self.i += 1
        return _value(text)

    def _block_scalar(self, header: str, indent: int) -> str:
        chomp = "-" if "-" in header else ("+" if "+" in header else "")
        body, block_ind = [], None
        while self.i < len(self.lines):
            ind, content, raw = self.lines[self.i]
            if raw.strip() and ind <= indent:
                break
            if raw.strip() and block_ind is None:
                block_ind = ind
            body.append(raw[block_ind:] if raw.strip() else "")
            self.i += 1
        while body and not body[-1] and chomp != "+":
            body.pop()
        if header[0] == ">":
            text = re.sub(r"(?<!\n)\n(?!\n)", " ", "\n".join(body))
        else:
            text = "\n".join(body)
        return text if chomp == "-" else text + "\n"

    def _map(self, indent: int) -> dict:
        out = {}
        while True:
            self._skip_blank()
            if self.i >= len(self.lines):
                return out
            ind, content, _ = self.lines[self.i]
            if ind < indent:
                return out
            if ind > indent:
                raise ValueError(f"bad indentation at line {self.i + 1}: {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise ValueError(f"expected 'key: value' at line {self.i + 1}: {content!r}")
            key, rest = kv
            self.i += 1
            if rest.strip():
                out[key] = self._inline(rest, indent)
                continue
            self._skip_blank()
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt and (nxt[0] > indent or (nxt[0] == indent and nxt[1].startswith("-"))):
                out[key] = self._node(nxt[0])
            else:
                out[key] = None

    def _seq(self, indent: int) -> list:
        out = []
        while True:
            self._skip_blank()
            if self.i >= len(self.lines):
                return out
            ind, content, raw = self.lines[self.i]
            if ind != indent or not (content.startswith("- ") or content == "-"):
                return out
            rest = content[1:].strip()
            if not rest:
                self.i += 1
                self._skip_blank()
                out.append(self._node(self.lines[self.i][0]) if self.i < len(self.lines)
                           and self.lines[self.i][0] > indent else None)
            elif _split_key(rest) is not None and rest[0] not in "[{":
                # '- key: value' opens a mapping whose keys sit at the item's column
                col = indent + (len(content) - len(rest))
                self.lines[self.i] = (col, rest, " " * col + rest)
                out.append(self._map(col))
            else:
                self.i += 1
                out.append(self._inline(rest, indent))


def yaml_load(file: str | Path, append_filename: bool = False) -> dict:
    """Load a YAML file to a dict (edgeyolo_tpu/utils::yaml_load), with the
    file's path under `yaml_file` when `append_filename`."""
    path = Path(file)
    if path.suffix not in {".yaml", ".yml"}:
        raise ValueError(f"not a YAML file: {file}")
    s = path.read_text(errors="ignore", encoding="utf-8")
    if not s.isprintable():
        s = re.sub(r"[^\x09\x0A\x0D\x20-\x7E\x85\xA0-퟿-�\U00010000-\U0010ffff]+",
                   "", s)
    data = _Parser(s).parse() or {}
    if append_filename:
        data["yaml_file"] = str(file)
    return data


def yaml_loads(text: str):
    """Parse YAML text (the same subset as `yaml_load`)."""
    return _Parser(text).parse()


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    s = str(v)
    if _value(s) != s or s != s.strip() or any(c in s for c in ":#'\"[]{},") or not s:
        return "'" + s.replace("'", "''") + "'"
    return s


def yaml_save(file: str | Path, data: dict, header: str = "") -> None:
    """Write a flat dict of scalars and lists (a run's args.yaml), after the
    `header` text (comment lines); `yaml_load` reads it back."""
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for k, v in data.items():
        if isinstance(v, dict):
            lines.append(f"{k}:")
            lines += [f"  {_dump_scalar(kk)}: {_dump_scalar(vv)}" for kk, vv in v.items()]
        else:
            lines.append(f"{k}: {_dump_scalar(v if not isinstance(v, Path) else str(v))}")
    file.write_text(header + "\n".join(lines) + "\n")
