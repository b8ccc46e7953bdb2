"""A small line-oriented C++ lexer — just enough to scan the native runtime.

Full C++ parsing is out of scope (and out of proportion: the registry
checker only needs to see which string literals flow into
``log_event_locked``).  This lexer handles exactly the constructs that would
otherwise produce false tokens: ``//`` and ``/* */`` comments, string and
character literals (with escapes), and raw strings ``R"(...)"`` — and emits
a flat token stream of identifiers, string literals, and single-character
punctuation with 1-based line numbers.
"""

from __future__ import annotations

import dataclasses
import re

IDENT = "ident"
STRING = "string"
PUNCT = "punct"


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # IDENT | STRING | PUNCT
    value: str  # STRING tokens hold the *decoded* literal text
    line: int  # 1-based


_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_SIMPLE_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\",
    '"': '"', "'": "'",
}


def tokenize(source: str) -> list[Token]:
    toks: list[Token] = []
    i, n, line = 0, len(source), 1
    while i < n:
        c = source[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r\f\v":
            i += 1
        elif source.startswith("//", i):
            j = source.find("\n", i)
            i = n if j < 0 else j  # newline handled above (keeps line count)
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            line += source.count("\n", i, j)
            i = j
        elif source.startswith('R"', i):
            # Raw string: R"delim( ... )delim"
            m = re.match(r'R"([^()\\ ]*)\(', source[i:])
            if m is None:
                toks.append(Token(PUNCT, c, line))
                i += 1
                continue
            close = f"){m.group(1)}\""
            j = source.find(close, i + m.end())
            j = n if j < 0 else j
            body = source[i + m.end() : j]
            toks.append(Token(STRING, body, line))
            line += source.count("\n", i, j)
            i = min(j + len(close), n)
        elif c in "\"'":
            quote, j, out = c, i + 1, []
            while j < n and source[j] != quote:
                if source[j] == "\\" and j + 1 < n:
                    out.append(_SIMPLE_ESCAPES.get(source[j + 1], source[j + 1]))
                    j += 2
                else:
                    out.append(source[j])
                    j += 1
            if c == '"':
                toks.append(Token(STRING, "".join(out), line))
            line += source.count("\n", i, j)
            i = j + 1
        else:
            m = _IDENT_RE.match(source, i)
            if m:
                toks.append(Token(IDENT, m.group(), line))
                i = m.end()
            else:
                toks.append(Token(PUNCT, c, line))
                i += 1
    return toks


def call_string_args(source: str, callee: str) -> list[Token]:
    """First string-literal argument of every ``callee(...)`` call.

    Scans the token stream for ``callee`` followed by ``(`` and returns the
    first STRING token before the matching close paren (calls whose first
    string sits in a nested call are fine: the event-name argument is by
    convention the literal closest to the open paren).  Calls with no string
    literal at all contribute nothing.
    """
    toks = tokenize(source)
    out: list[Token] = []
    for i, t in enumerate(toks):
        if t.kind != IDENT or t.value != callee:
            continue
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        if nxt is None or nxt.kind != PUNCT or nxt.value != "(":
            continue
        depth = 0
        for u in toks[i + 1 :]:
            if u.kind == PUNCT and u.value == "(":
                depth += 1
            elif u.kind == PUNCT and u.value == ")":
                depth -= 1
                if depth == 0:
                    break
            elif u.kind == STRING:
                out.append(u)
                break
    return out
