"""A reader for the subset of YAML that the released configs are written in.

``configs/*.yaml`` come from ``yaml.safe_dump(cfg, sort_keys=True,
default_flow_style=None)`` (``tools/gen_configs.py``), and the machines the
port runs on need not have PyYAML, so the port reads them itself.  The
subset:

* block mappings, nested by indentation (spaces only);
* flow mappings ``{A: b, C: [1, 2]}`` and flow sequences ``[1, 2]``, nested,
  and continued over more-indented lines;
* plain, single-quoted and double-quoted scalars (a line break inside a
  scalar folds to one space, as YAML folds it), and ``#`` comments.

Plain scalars resolve as PyYAML's YAML 1.1 resolver (``yaml/resolver.py``)
and constructors resolve them: ``true``/``false`` (and ``yes``/``no``/
``on``/``off``) to bools, ints (decimal, ``0x``, ``0b``, leading-``0``
octal, ``:`` base 60), floats only with a dot (``1.0e-05``; ``1e-5`` and
``1.0e5`` stay strings, since an exponent needs its sign), ``.inf`` /
``.nan``, ``null`` / ``~`` / nothing to None, anything else to a string.
Quoted scalars are strings.

Everything else raises ``ValueError`` naming the line: tabs, anchors,
aliases and tags, documents (``---``, ``...``, ``%`` directives), block
sequences (``- x``), block scalars (``|``, ``>``), complex keys (``?``),
escapes in double-quoted scalars, plain scalars that PyYAML would resolve
to a type outside the subset (timestamps, ``<<``, ``=``), blank lines inside
a value, and duplicate keys.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), in its order.
_BOOL = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False'
                   r'|FALSE|on|On|ON|off|Off|OFF)$')
_FLOAT = re.compile(r'^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*'
                    r'|[-+]?\.(?:inf|Inf|INF)'
                    r'|\.(?:nan|NaN|NAN))$')
_INT = re.compile(r'^(?:[-+]?0b[0-1_]+'
                  r'|[-+]?0[0-7_]+'
                  r'|[-+]?(?:0|[1-9][0-9_]*)'
                  r'|[-+]?0x[0-9a-fA-F_]+'
                  r'|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$')
_NULL = re.compile(r'^(?:~|null|Null|NULL|)$')
# Resolved by PyYAML to types outside the subset.
_OTHER = (('a merge key', re.compile(r'^(?:<<)$')),
          ('a timestamp', re.compile(
              r'^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]'
              r'|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?'
              r'(?:[Tt]|[ \t]+)[0-9][0-9]?'
              r':[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?'
              r'(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$')),
          ('a value key', re.compile(r'^(?:=)$')))

_FLOW_INDICATORS = ',[]{}'
# Characters that cannot start a plain scalar, and what they start instead.
_STARTS = {'&': 'an anchor', '*': 'an alias', '!': 'a tag',
           '|': 'a block scalar', '>': 'a block scalar', '%': 'a directive',
           '@': 'a reserved indicator', '`': 'a reserved indicator',
           '#': 'a comment', ',': 'a flow indicator', ']': 'a flow indicator',
           '}': 'a flow indicator'}


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    for part in text.split(':'):
        value = value * 60 + cast(part)
    return value


def _int(text: str) -> int:
    """PyYAML's ``construct_yaml_int``."""
    text = text.replace('_', '')
    sign = -1 if text[0] == '-' else 1
    if text[0] in '+-':
        text = text[1:]
    if text == '0':
        return 0
    if text.startswith('0b'):
        return sign * int(text[2:], 2)
    if text.startswith('0x'):
        return sign * int(text[2:], 16)
    if text[0] == '0':
        return sign * int(text, 8)
    if ':' in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    """PyYAML's ``construct_yaml_float``."""
    text = text.replace('_', '').lower()
    sign = -1 if text[0] == '-' else 1
    if text[0] in '+-':
        text = text[1:]
    if text == '.inf':
        return sign * float('inf')
    if text == '.nan':
        return float('nan')
    if ':' in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _resolve_plain(text: str) -> Any:
    """The value of a plain scalar, as PyYAML's ``safe_load`` gives it;
    ``ValueError`` where that is a type outside the subset."""
    if _BOOL.match(text):
        return text.lower() in ('yes', 'true', 'on')
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _NULL.match(text):
        return None
    for what, pattern in _OTHER:
        if pattern.match(text):
            raise ValueError('{!r} is {}, outside the subset'.format(text,
                                                                      what))
    return text


class _Scanner:
    """The nodes of one value: its text (the rest of a ``key:`` line and
    its continuation lines, joined by newlines) from line ``line``."""

    def __init__(self, text: str, line: int):
        self.text, self.line, self.pos = text, line, 0

    def error(self, msg: str, pos: int | None = None) -> ValueError:
        pos = self.pos if pos is None else pos
        return ValueError('line {}: {}'.format(
            self.line + self.text.count('\n', 0, pos), msg))

    def peek(self, offset: int = 0) -> str:
        i = self.pos + offset
        return self.text[i] if i < len(self.text) else ''

    def skip_space(self) -> None:
        """Skip spaces, line breaks and comments."""
        text = self.text
        while self.pos < len(text):
            c = text[self.pos]
            if c in ' \n':
                self.pos += 1
            elif c == '#' and (self.pos == 0 or text[self.pos - 1] in ' \n'):
                end = text.find('\n', self.pos)
                self.pos = len(text) if end < 0 else end
            else:
                return

    def at_end(self) -> bool:
        self.skip_space()
        return self.pos >= len(self.text)

    def separator_at(self, i: int, flow: bool) -> bool:
        """Whether ``:`` before position ``i`` ends a key."""
        return i >= len(self.text) or self.text[i] in ' \n' or (
            flow and self.text[i] in _FLOW_INDICATORS)

    def node(self, flow: bool) -> Any:
        self.skip_space()
        c = self.peek()
        if c == '{':
            return self.flow_mapping()
        if c == '[':
            return self.flow_sequence()
        if c in ('"', "'"):
            return self.quoted()
        start = self.pos
        text = self.plain(flow)
        try:
            return _resolve_plain(text)
        except ValueError as e:
            raise self.error(str(e), start)

    def plain(self, flow: bool) -> str:
        """A plain scalar's text; it ends at ``: ``, at `` #``, at the end
        and, in a flow collection, at ``,[]{}?``."""
        text, start = self.text, self.pos
        c, nxt = self.peek(), self.peek(1)
        if c in _STARTS:
            raise self.error('{!r} starts {}, outside the subset'.format(
                c, _STARTS[c]))
        if c and c in '-?:' and (nxt in ('', ' ', '\n') or (
                flow and (c != '-' or nxt in _FLOW_INDICATORS))):
            raise self.error(
                {'-': 'a block sequence entry', '?': 'a complex key',
                 ':': 'an empty key'}[c] + ' is outside the subset')
        chunks: List[str] = []
        i = start
        while i < len(text):
            c = text[i]
            if c in ' \n':
                j = i
                while j < len(text) and text[j] in ' \n':
                    j += 1
                if j == len(text) or text[j] == '#' or (
                        flow and text[j] in _FLOW_INDICATORS + '?') or (
                        text[j] == ':' and self.separator_at(j + 1, flow)):
                    break
                chunks.append(' ' if '\n' in text[i:j] else text[i:j])
                i = j
                continue
            if (c == ':' and self.separator_at(i + 1, flow)) or (
                    flow and c in _FLOW_INDICATORS + '?'):
                break
            chunks.append(c)
            i += 1
        if i == start:
            raise self.error('expected a scalar')
        self.pos = i
        return ''.join(chunks)

    def quoted(self) -> str:
        """A single- or double-quoted scalar (no escapes in the latter)."""
        text, quote = self.text, self.peek()
        start = self.pos
        i = self.pos + 1
        chunks: List[str] = []
        while True:
            if i >= len(text):
                raise self.error('unterminated quoted scalar', start)
            c = text[i]
            if c == quote:
                if quote == "'" and i + 1 < len(text) and text[i + 1] == "'":
                    chunks.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return ''.join(chunks)
            if c == '\\' and quote == '"':
                raise self.error('escape sequences are outside the subset', i)
            if c in ' \n':
                j = i
                while j < len(text) and text[j] in ' \n':
                    j += 1
                chunks.append(' ' if '\n' in text[i:j] else text[i:j])
                i = j
                continue
            chunks.append(c)
            i += 1

    def key(self, flow: bool) -> Any:
        """A mapping key: a scalar, then ``:``."""
        self.skip_space()
        if self.peek() in ('{', '['):
            raise self.error('collection keys are outside the subset')
        quoted = self.peek() in ('"', "'")
        key = self.node(flow)
        self.skip_space()
        # In a flow mapping ':' may follow a quoted key directly.
        if self.peek() != ':' or not (self.separator_at(self.pos + 1, flow)
                                      or (flow and quoted)):
            raise self.error("expected ':' after the key {!r}".format(key))
        self.pos += 1
        return key

    def flow_mapping(self) -> dict:
        start = self.pos
        self.pos += 1
        out: dict = {}
        while True:
            self.skip_space()
            if self.peek() == '}':
                self.pos += 1
                return out
            if self.peek() == '':
                raise self.error('unterminated flow mapping', start)
            at = self.pos
            key = self.key(flow=True)
            self.skip_space()
            if self.peek() in (',', '}'):
                raise self.error('an empty value is outside the subset')
            if key in out:
                raise self.error('duplicate key {!r}'.format(key), at)
            out[key] = self.node(flow=True)
            self.skip_space()
            if self.peek() == ',':
                self.pos += 1
            elif self.peek() != '}':
                raise self.error("expected ',' or '}' in a flow mapping")

    def flow_sequence(self) -> list:
        start = self.pos
        self.pos += 1
        out: list = []
        while True:
            self.skip_space()
            if self.peek() == ']':
                self.pos += 1
                return out
            if self.peek() == '':
                raise self.error('unterminated flow sequence', start)
            out.append(self.node(flow=True))
            self.skip_space()
            if self.peek() == ',':
                self.pos += 1
            elif self.peek() == ':':
                raise self.error('mappings inside a flow sequence are '
                                 'outside the subset')
            elif self.peek() != ']':
                raise self.error("expected ',' or ']' in a flow sequence")


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(' '))


def _is_comment_or_blank(line: str) -> bool:
    s = line.strip(' ')
    return not s or s.startswith('#')


class _Reader:

    def __init__(self, text: str):
        if text.startswith('\ufeff'):           # a byte order mark
            text = text[1:]
        self.lines = text.replace('\r\n', '\n').split('\n')
        for number, line in enumerate(self.lines, 1):
            if '\t' in line:
                raise ValueError('line {}: tabs are outside the subset'.format(
                    number))
            if '\r' in line:
                raise ValueError('line {}: a bare carriage return is outside '
                                 'the subset'.format(number))
            if re.match(r'(---|\.\.\.)( |$)', line) or line.startswith('%'):
                raise ValueError('line {}: documents and directives are '
                                 'outside the subset'.format(number))

    def next_content(self, i: int) -> int:
        while i < len(self.lines) and _is_comment_or_blank(self.lines[i]):
            i += 1
        return i

    def block_mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        """The block mapping whose keys sit at ``indent`` from line index
        ``i``; returns it and the index of the first line after it."""
        out: dict = {}
        lines = self.lines
        while True:
            i = self.next_content(i)
            if i >= len(lines) or _indent(lines[i]) < indent:
                return out, i
            if _indent(lines[i]) > indent:
                raise ValueError('line {}: unexpected indentation'.format(
                    i + 1))
            scanner = _Scanner(lines[i], i + 1)
            scanner.pos = indent
            key = scanner.key(flow=False)
            if key in out:
                raise ValueError('line {}: duplicate key {!r}'.format(i + 1,
                                                                       key))
            rest = lines[i][scanner.pos:]
            if _is_comment_or_blank(rest):
                # A nested block mapping, or nothing (null).
                j = self.next_content(i + 1)
                if j < len(lines) and _indent(lines[j]) > indent:
                    out[key], i = self.block_mapping(j, _indent(lines[j]))
                else:
                    out[key], i = None, i + 1
                continue
            # The value: the rest of this line and the more-indented lines
            # after it (a flow collection or a scalar continued).
            out[key], i = self.value(rest, i, indent)

    def value(self, first: str, i: int, indent: int) -> Tuple[Any, int]:
        """The value that starts with ``first`` on line index ``i`` and
        goes on over the lines indented more than ``indent`` (a flow
        collection or a scalar continued); returns it and the index of the
        first line after it."""
        lines = self.lines
        end, blank = i + 1, None
        for j in range(i + 1, len(lines)):
            if not lines[j].strip(' '):
                blank = j if blank is None else blank
                continue
            if _indent(lines[j]) <= indent:
                break
            if blank is not None:
                raise ValueError('line {}: a blank line inside a value is '
                                 'outside the subset'.format(blank + 1))
            end = j + 1
        scanner = _Scanner('\n'.join([first] + lines[i + 1:end]), i + 1)
        value = scanner.node(flow=False)
        if not scanner.at_end():
            raise scanner.error('unexpected {!r} after the value'.format(
                scanner.peek()))
        return value, end

    def document(self) -> Any:
        i = self.next_content(0)
        if i >= len(self.lines):
            return None
        if self.lines[i].lstrip(' ')[0] in '{[':      # a flow collection
            out, i = self.value(self.lines[i], i, -1)
        else:
            out, i = self.block_mapping(i, _indent(self.lines[i]))
        i = self.next_content(i)
        if i < len(self.lines):
            raise ValueError('line {}: unexpected indentation'.format(i + 1))
        return out


def load(text: str) -> Any:
    """The document in ``text``: a dict (None for an empty document), as
    ``yaml.safe_load`` reads it; ``ValueError`` naming the line for what
    lies outside the subset."""
    return _Reader(text).document()


def load_file(path: str) -> Any:
    """:func:`load` of the file at ``path``."""
    with open(path, 'r', encoding='utf-8') as f:
        return load(f.read())
