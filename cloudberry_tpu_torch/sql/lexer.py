"""SQL lexer — hand-rolled, no dependencies (no sqlglot in the image).

The reference uses flex (src/backend/parser/scan.l). Token kinds: IDENT,
NUMBER, STRING, OP, punctuation; keywords are uppercased IDENTs checked by
the parser (case-insensitive, PG style).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Token:
    kind: str   # 'ident' | 'number' | 'string' | 'op' | 'eof'
    text: str   # idents lowercased; strings unquoted; ops literal
    pos: int


_TWO_CHAR_OPS = ("<=", ">=", "<>", "!=", "||")
_ONE_CHAR_OPS = "+-*/%=<>(),.;"


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at {i}")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError(f"unterminated quoted identifier at {i}")
            out.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (sql[j].isdigit() or (sql[j] == "." and not seen_dot)):
                if sql[j] == ".":
                    # "1." followed by non-digit is number then dot (e.g. 1..2)
                    if j + 1 >= n or not sql[j + 1].isdigit():
                        break
                    seen_dot = True
                j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    while k < n and sql[k].isdigit():
                        k += 1
                    j = k
            out.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            out.append(Token("ident", sql[i:j].lower(), i))
            i = j
            continue
        if sql[i:i + 2] in _TWO_CHAR_OPS:
            out.append(Token("op", sql[i:i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            out.append(Token("op", c, i))
            i += 1
            continue
        raise LexError(f"unexpected character {c!r} at position {i}")
    out.append(Token("eof", "", n))
    return out
