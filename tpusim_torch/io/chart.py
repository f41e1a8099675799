"""Helm-chart rendering for app manifests (counterpart of
tpusim/io/chart.py; ref: pkg/chart/chart.go
ProcessChart, which loads a chart and renders it through the real Helm
engine to YAML docs, dropping NOTES.txt and empty manifests).

This module implements the Go-template subset that real-world charts (and
`helm create` scaffolding) use, without a Go toolchain:

  actions     {{ pipeline }}, {{- ... -}} whitespace trimming, {{/* */}}
  control     if / else if / else, range (with $i, $v := assignment),
              with, define / template / include, end
  data        .Values.x.y field chains, $ (root), $var variables,
              string/number/bool literals, parenthesized sub-pipelines
  functions   default quote squote upper lower title trunc trimSuffix
              trimPrefix replace indent nindent toYaml printf eq ne lt le
              gt ge and or not empty coalesce required len
  helpers     templates/_*.tpl files are parsed for their define blocks

Files named NOTES.txt are skipped like the reference's renderResources
(chart.go:116-130); empty rendered manifests are dropped. Anything
genuinely outside the subset raises ChartError naming the directive, with
`helm template` pre-rendering as the escape hatch.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import yaml


class ChartError(ValueError):
    pass


# ---------------------------------------------------------------------------
# tokenizer: text / {{ action }} stream with {{- / -}} trimming
# ---------------------------------------------------------------------------

_COMMENT = re.compile(r"/\*.*?\*/", re.S)


def _scan_action(src: str, i: int) -> int:
    """`i` points just past '{{'; return the index of the closing '}}',
    skipping over quoted string literals (a '}}' inside "..."/'...'/`...`
    is data, not a delimiter). -1 when unterminated."""
    n = len(src)
    while i < n:
        ch = src[i]
        if ch in "\"'`":
            i += 1
            while i < n and src[i] != ch:
                i += 2 if ch == '"' and src[i] == "\\" else 1
            i += 1
        elif ch == "}" and src.startswith("}}", i):
            return i
        else:
            i += 1
    return -1


def _tokenize(src: str) -> List[Tuple[str, str]]:
    """→ [(kind, payload)]: kind 'text' or 'action'. Handles `{{- `/` -}}`
    whitespace trimming (Go spec: the minus must be flanked by whitespace
    or the delimiter to count as a trim marker, not a negative number)."""
    out: List[Tuple[str, str]] = []
    pos = 0
    while True:
        start = src.find("{{", pos)
        if start < 0:
            break
        body_start = start + 2
        ltrim = src.startswith("-", body_start) and (
            body_start + 1 >= len(src) or src[body_start + 1] in " \t\n\r"
        )
        if ltrim:
            body_start += 1
        end = _scan_action(src, body_start)
        if end < 0:
            raise ChartError(f"unterminated template action: {src[start:start+40]!r}")
        body = src[body_start:end]
        rtrim = body.rstrip().endswith("-") and (
            len(body.rstrip()) == 1 or body.rstrip()[-2] in " \t\n\r"
        )
        if rtrim:
            body = body.rstrip()[:-1]
        text = src[pos:start]
        if ltrim:
            text = text.rstrip(" \t\n\r")
        if text:
            out.append(("text", text))
        expr = _COMMENT.sub("", body).strip()
        if expr:
            out.append(("action", expr))
        pos = end + 2
        if rtrim:
            while pos < len(src) and src[pos] in " \t\n\r":
                pos += 1
    if pos < len(src):
        out.append(("text", src[pos:]))
    return out


# ---------------------------------------------------------------------------
# parser: token stream → node tree
# ---------------------------------------------------------------------------


class _Text:
    def __init__(self, s):
        self.s = s


class _Pipe:
    def __init__(self, expr):
        self.expr = expr


class _If:
    def __init__(self):
        self.branches: List[Tuple[str, list]] = []  # (cond expr, body)
        self.else_body: list = []


class _Range:
    def __init__(self, decl, expr):
        self.decl = decl  # [] | [$v] | [$k, $v]
        self.expr = expr
        self.body: list = []
        self.else_body: list = []


class _With:
    def __init__(self, expr):
        self.expr = expr
        self.body: list = []
        self.else_body: list = []


class _Template:
    def __init__(self, expr):
        self.expr = expr  # '"name" pipeline?'


class _Var:
    def __init__(self, name, expr):
        self.name = name
        self.expr = expr


_KEYWORD = re.compile(r"^(if|range|with|define|template|else|end|block)\b")
_ASSIGN = re.compile(r"^(\$[\w]*)\s*:?=\s*(.*)$", re.S)
_RANGE_DECL = re.compile(
    r"^(\$[\w]+)\s*(?:,\s*(\$[\w]+)\s*)?:=\s*(.*)$", re.S
)


def _parse(tokens, i, templates, stop=("end",)):
    """Parse until a stop keyword; returns (nodes, stop_word, stop_expr, i)."""
    nodes: list = []
    while i < len(tokens):
        kind, payload = tokens[i]
        i += 1
        if kind == "text":
            nodes.append(_Text(payload))
            continue
        m = _KEYWORD.match(payload)
        word = m.group(1) if m else None
        rest = payload[m.end() :].strip() if m else payload
        if word in stop:
            return nodes, word, rest, i
        if word == "if":
            node = _If()
            cond = rest
            while True:
                body, stop_word, stop_expr, i = _parse(
                    tokens, i, templates, stop=("end", "else")
                )
                node.branches.append((cond, body))
                if stop_word == "end":
                    break
                if stop_expr.startswith("if"):
                    cond = stop_expr[2:].strip()
                    continue
                node.else_body, stop_word, _, i = _parse(
                    tokens, i, templates, stop=("end",)
                )
                break
            nodes.append(node)
        elif word == "range":
            dm = _RANGE_DECL.match(rest)
            if dm:
                decl = [v for v in (dm.group(1), dm.group(2)) if v]
                expr = dm.group(3)
            else:
                decl, expr = [], rest
            node = _Range(decl, expr)
            node.body, stop_word, _, i = _parse(
                tokens, i, templates, stop=("end", "else")
            )
            if stop_word == "else":
                node.else_body, _, _, i = _parse(tokens, i, templates)
            nodes.append(node)
        elif word == "with":
            node = _With(rest)
            node.body, stop_word, _, i = _parse(
                tokens, i, templates, stop=("end", "else")
            )
            if stop_word == "else":
                node.else_body, _, _, i = _parse(tokens, i, templates)
            nodes.append(node)
        elif word in ("define", "block"):
            name = rest.strip().strip("\"'")
            body, _, _, i = _parse(tokens, i, templates)
            templates[name] = body
            if word == "block":  # block also renders in place
                nodes.append(_Template(rest))
        elif word == "template":
            nodes.append(_Template(rest))
        else:
            am = _ASSIGN.match(payload)
            if am:
                nodes.append(_Var(am.group(1), am.group(2)))
            else:
                nodes.append(_Pipe(payload))
    return nodes, None, None, i


# ---------------------------------------------------------------------------
# pipeline evaluation
# ---------------------------------------------------------------------------


def _truthy(v) -> bool:
    """Go-template truth: false/0/""/nil/empty collection are false."""
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, tuple, dict)) and len(v) == 0:
        return False
    return True


def _split_top(s: str, sep: str) -> List[str]:
    """Split on `sep` outside quotes/parens."""
    parts, depth, quote, cur = [], 0, "", []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = ""
            continue
        if ch in "\"'`":
            quote = ch
            cur.append(ch)
        elif ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


_TOKEN = re.compile(
    r"""\(|\)|"(?:[^"\\]|\\.)*"|'[^']*'|`[^`]*`|[^\s()]+""", re.S
)


class _Ctx:
    def __init__(self, root, dot, vars, templates):
        self.root = root
        self.dot = dot
        self.vars = vars
        self.templates = templates

    def child(self, dot=None, vars=None):
        return _Ctx(
            self.root,
            self.dot if dot is None else dot,
            dict(self.vars if vars is None else vars),
            self.templates,
        )


def _field_chain(base, path: str, expr: str):
    cur = base
    for part in path.split("."):
        if not part:
            continue
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif cur is None:
            return None
        else:
            raise ChartError(f"cannot access .{part} in {{{{ {expr} }}}}")
    return cur


def _eval_atom(tok: str, ctx: _Ctx, expr: str):
    if tok == ".":
        return ctx.dot
    if tok == "$":
        return ctx.root
    if tok.startswith("$."):
        return _field_chain(ctx.root, tok[2:], expr)
    if tok.startswith("$"):
        name = tok.split(".", 1)
        if name[0] not in ctx.vars:
            raise ChartError(f"undefined variable {name[0]} in {{{{ {expr} }}}}")
        v = ctx.vars[name[0]]
        return _field_chain(v, name[1], expr) if len(name) > 1 else v
    if tok.startswith("."):
        return _field_chain(ctx.dot, tok[1:], expr)
    if tok[0] in "\"'`":
        s = tok[1:-1]
        return s.replace('\\"', '"').replace("\\n", "\n").replace("\\t", "\t") if tok[0] == '"' else s
    if tok in ("true", "false"):
        return tok == "true"
    if tok in ("nil", "null"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    raise ChartError(f"unsupported token {tok!r} in {{{{ {expr} }}}}")


def _to_yaml(v) -> str:
    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip("\n")


def _indent(n: int, s: str) -> str:
    pad = " " * n
    return "\n".join(pad + line if line else line for line in s.splitlines())


def _go_str(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _printf(fmt: str, *args) -> str:
    # Go verbs used by charts: %s %d %v %q (+ %% escape)
    out, ai = [], 0
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            verb = fmt[i + 1]
            i += 2
            if verb == "%":
                out.append("%")
                continue
            arg = args[ai] if ai < len(args) else None
            ai += 1
            if verb == "q":
                out.append(f'"{_go_str(arg)}"')
            elif verb == "d":
                out.append(str(int(arg)))
            else:  # s, v
                out.append(_go_str(arg))
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _semver_compare(constraint, version):
    """Minimal semverCompare: one `[op]x.y.z` constraint against a version.
    Helm's range/caret/tilde/wildcard syntax is outside the subset → ChartError."""
    # only the ubiquitous "-0" prerelease-inclusive idiom (">=1.19.0-0") is
    # accepted on the constraint side; other prerelease constraints have
    # ordering semantics the subset doesn't model and raise below
    m = re.match(
        r"^\s*(>=|<=|!=|>|<|=)?\s*v?(\d+(?:\.\d+){0,2})(-0)?\s*$",
        str(constraint),
    )
    # build metadata (+...) is ignored like Helm does. A prerelease version
    # (1.27.3-gke.100) compares by its numeric core ONLY when the constraint
    # opted into prereleases via "-0"; against a plain constraint Helm
    # EXCLUDES prereleases, which the subset doesn't model — raise.
    vm = re.match(
        r"^\s*v?(\d+(?:\.\d+){0,2})(-[\w.-]+)?(?:\+[\w.-]+)?\s*$",
        str(version),
    )
    if not m or not vm or (vm.group(2) and not m.group(3)):
        raise ChartError(
            f"semverCompare: unsupported constraint {constraint!r} vs {version!r} "
            "(the subset models single [>=|<=|>|<|=|!=]x.y.z constraints; "
            "prerelease versions only against a '-0'-suffixed constraint)"
        )
    op = m.group(1) or "="
    # the numeric-core comparison is only sound for a '-0' (minimal
    # prerelease) constraint under >= and < — under =, !=, > and <= the
    # version's own prerelease ordering would decide, which the subset
    # doesn't model
    if m.group(3) and op not in (">=", "<"):
        raise ChartError(
            f"semverCompare: unsupported constraint {constraint!r} "
            "('-0' prerelease constraints are only modeled under >= and <)"
        )
    want = tuple(int(x) for x in m.group(2).split("."))
    have = tuple(int(x) for x in vm.group(1).split("."))[: len(want)]
    have = have + (0,) * (len(want) - len(have))
    return {
        "=": have == want, "!=": have != want,
        ">": have > want, ">=": have >= want,
        "<": have < want, "<=": have <= want,
    }[op]


def _make_funcs(render_template, render_string):
    def required(msg, v):
        if v is None or v == "":
            raise ChartError(f"required value missing: {msg}")
        return v

    return {
        "default": lambda d, v=None: v if _truthy(v) else d,
        "quote": lambda *a: " ".join(f'"{_go_str(x)}"' for x in a),
        "squote": lambda *a: " ".join(f"'{_go_str(x)}'" for x in a),
        "upper": lambda s: _go_str(s).upper(),
        "lower": lambda s: _go_str(s).lower(),
        "title": lambda s: _go_str(s).title(),
        "trim": lambda s: _go_str(s).strip(),
        "trunc": lambda n, s: _go_str(s)[: int(n)]
        if int(n) >= 0
        else _go_str(s)[int(n) :],
        "trimSuffix": lambda suf, s: _go_str(s)[: -len(suf)]
        if suf and _go_str(s).endswith(suf)
        else _go_str(s),
        "trimPrefix": lambda pre, s: _go_str(s)[len(pre) :]
        if pre and _go_str(s).startswith(pre)
        else _go_str(s),
        "replace": lambda old, new, s: _go_str(s).replace(old, new),
        "indent": lambda n, s: _indent(int(n), _go_str(s)),
        "nindent": lambda n, s: "\n" + _indent(int(n), _go_str(s)),
        "toYaml": _to_yaml,
        "printf": _printf,
        "print": lambda *a: "".join(_go_str(x) for x in a),
        "eq": lambda a, *b: any(a == x for x in b),
        "ne": lambda a, b: a != b,
        "lt": lambda a, b: a < b,
        "le": lambda a, b: a <= b,
        "gt": lambda a, b: a > b,
        "ge": lambda a, b: a >= b,
        "and": lambda *a: next((x for x in a if not _truthy(x)), a[-1]),
        "or": lambda *a: next((x for x in a if _truthy(x)), a[-1]),
        "not": lambda v: not _truthy(v),
        "empty": lambda v: not _truthy(v),
        "coalesce": lambda *a: next((x for x in a if _truthy(x)), None),
        "required": required,
        "len": lambda v: len(v),
        "include": render_template,
        "tpl": render_string,
        "list": lambda *a: list(a),
        "dict": lambda *a: {a[i]: a[i + 1] for i in range(0, len(a), 2)},
        "add": lambda *a: sum(a),
        "sub": lambda a, b: a - b,
        "int": lambda v: int(v),
        "toString": _go_str,
        "kindIs": lambda kind, v: {
            "map": isinstance(v, dict),
            "slice": isinstance(v, (list, tuple)),
            "string": isinstance(v, str),
            "bool": isinstance(v, bool),
        }.get(kind, False),
        "hasKey": lambda d, k: isinstance(d, dict) and k in d,
        "contains": lambda sub, s: sub in _go_str(s),
        "semverCompare": _semver_compare,
    }


class _Renderer:
    def __init__(self, templates: Dict[str, list], root):
        self.templates = templates
        self.root = root
        self.funcs = _make_funcs(self._include, self._tpl)

    # include "name" dot → string
    def _include(self, name, dot=None):
        body = self.templates.get(name)
        if body is None:
            raise ChartError(f"undefined template {name!r}")
        ctx = _Ctx(self.root, dot if dot is not None else self.root, {"$": self.root}, self.templates)
        return self._render(body, ctx)

    # tpl "string" dot → re-parse and render the string as a template
    def _tpl(self, s, dot=None):
        body, _, _, _ = _parse(_tokenize(_go_str(s)), 0, self.templates, stop=())
        ctx = _Ctx(self.root, dot if dot is not None else self.root, {"$": self.root}, self.templates)
        return self._render(body, ctx)

    def _eval_segment(self, seg: str, ctx: _Ctx, piped, expr: str):
        toks: List[str] = []
        # group parenthesized sub-pipelines into single tokens
        depth, cur = 0, []
        for t in _TOKEN.findall(seg):
            if t == "(":
                if depth:
                    cur.append(t)
                depth += 1
            elif t == ")":
                depth -= 1
                if depth:
                    cur.append(t)
                else:
                    toks.append("(" + " ".join(cur) + ")")
                    cur = []
            elif depth:
                cur.append(t)
            else:
                toks.append(t)
        if depth:
            raise ChartError(f"unbalanced parens in {{{{ {expr} }}}}")

        def atom(tok):
            if tok.startswith("(") and tok.endswith(")"):
                return self._eval_pipeline(tok[1:-1], ctx)
            return _eval_atom(tok, ctx, expr)

        if not toks:
            raise ChartError(f"empty pipeline segment in {{{{ {expr} }}}}")
        head = toks[0]
        if head in self.funcs:
            args = [atom(t) for t in toks[1:]]
            if piped is not _NO_PIPE:
                args.append(piped)
            return self.funcs[head](*args)
        if len(toks) > 1:
            raise ChartError(
                f"unsupported function {head!r} in {{{{ {expr} }}}}"
            )
        return atom(head)

    def _eval_pipeline(self, expr: str, ctx: _Ctx):
        piped = _NO_PIPE
        for seg in _split_top(expr, "|"):
            seg = seg.strip()
            if not seg:
                continue
            piped = self._eval_segment(seg, ctx, piped, expr)
        return piped

    def _render(self, nodes, ctx: _Ctx) -> str:
        out: List[str] = []
        for node in nodes:
            if isinstance(node, _Text):
                out.append(node.s)
            elif isinstance(node, _Pipe):
                out.append(_go_str(self._eval_pipeline(node.expr, ctx)))
            elif isinstance(node, _Var):
                ctx.vars[node.name] = self._eval_pipeline(node.expr, ctx)
            elif isinstance(node, _If):
                done = False
                for cond, body in node.branches:
                    if _truthy(self._eval_pipeline(cond, ctx)):
                        out.append(self._render(body, ctx))
                        done = True
                        break
                if not done:
                    out.append(self._render(node.else_body, ctx))
            elif isinstance(node, _With):
                v = self._eval_pipeline(node.expr, ctx)
                if _truthy(v):
                    out.append(self._render(node.body, ctx.child(dot=v)))
                else:
                    out.append(self._render(node.else_body, ctx))
            elif isinstance(node, _Range):
                v = self._eval_pipeline(node.expr, ctx)
                items: List[Tuple[Any, Any]]
                if isinstance(v, dict):
                    items = sorted(v.items())  # Go ranges maps in key order
                elif isinstance(v, (list, tuple)):
                    items = list(enumerate(v))
                elif v is None:
                    items = []
                else:
                    raise ChartError(f"cannot range over {type(v).__name__}")
                if not items:
                    out.append(self._render(node.else_body, ctx))
                for k, item in items:
                    sub = ctx.child(dot=item)
                    if len(node.decl) == 1:
                        sub.vars[node.decl[0]] = item
                    elif len(node.decl) == 2:
                        sub.vars[node.decl[0]] = k
                        sub.vars[node.decl[1]] = item
                    out.append(self._render(node.body, sub))
            elif isinstance(node, _Template):
                parts = _split_top(node.expr, " ")
                name = parts[0].strip().strip("\"'")
                dot_expr = " ".join(p for p in parts[1:] if p.strip())
                dot = self._eval_pipeline(dot_expr, ctx) if dot_expr else None
                out.append(self._include(name, dot))
        return "".join(out)


_NO_PIPE = object()


# ---------------------------------------------------------------------------
# chart loading (ProcessChart equivalents)
# ---------------------------------------------------------------------------


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def render_chart(name: str, path: str, values_override: Optional[dict] = None) -> List[str]:
    """Chart dir → list of rendered YAML document strings (the manifests
    the reference's renderResources returns: NOTES.txt removed, empty
    manifests dropped — chart.go:104-140)."""
    chart_yaml = os.path.join(path, "Chart.yaml")
    values_yaml = os.path.join(path, "values.yaml")
    tmpl_dir = os.path.join(path, "templates")
    if not os.path.isdir(tmpl_dir):
        raise ChartError(f"{path}: no templates/ directory")
    chart_meta = {}
    if os.path.exists(chart_yaml):
        with open(chart_yaml) as f:
            chart_meta = yaml.safe_load(f) or {}
    # only application charts are installable (chart.go:66-73)
    ctype = chart_meta.get("type", "")
    if ctype not in ("", "application"):
        raise ChartError(f"{ctype} charts are not installable")
    values = {}
    if os.path.exists(values_yaml):
        with open(values_yaml) as f:
            values = yaml.safe_load(f) or {}
    if values_override:
        values = _deep_merge(values, values_override)
    root = {
        "Values": values,
        "Release": {
            "Name": name,
            "Namespace": "default",
            "Revision": 1,
            "Service": "Helm",
            "IsInstall": True,
            "IsUpgrade": False,
        },
        "Chart": {
            **chart_meta,
            # engine exposes metadata capitalized (Chart.Name etc.)
            "Name": chart_meta.get("name", name),
            "Version": chart_meta.get("version", ""),
            "AppVersion": chart_meta.get("appVersion", ""),
        },
        "Capabilities": {"KubeVersion": {"Version": "v1.20.5", "GitVersion": "v1.20.5", "Major": "1", "Minor": "20"}},
        "Template": {"BasePath": os.path.join(name, "templates")},
    }

    templates: Dict[str, list] = {}
    render_files: List[Tuple[str, list]] = []
    for fname in sorted(os.listdir(tmpl_dir)):
        fpath = os.path.join(tmpl_dir, fname)
        if not os.path.isfile(fpath):
            continue
        is_helper = fname.startswith("_")
        if not (fname.endswith((".yaml", ".yml", ".tpl", ".txt"))):
            continue
        with open(fpath) as f:
            tokens = _tokenize(f.read())
        nodes, _, _, _ = _parse(tokens, 0, templates, stop=())
        # helpers contribute defines only; NOTES.txt is rendered then
        # discarded by the reference — skip it outright
        if is_helper or fname == "NOTES.txt":
            continue
        render_files.append((fname, nodes))

    renderer = _Renderer(templates, root)
    docs = []
    for fname, nodes in render_files:
        ctx = _Ctx(root, root, {"$": root}, templates)
        try:
            text = renderer._render(nodes, ctx)
        except ChartError as e:
            raise ChartError(f"{fname}: {e}") from None
        if text.strip():
            docs.append(text)
    return docs


def chart_objects(name: str, path: str) -> List[dict]:
    objs = []
    for doc in render_chart(name, path):
        for obj in yaml.safe_load_all(doc):
            if isinstance(obj, dict) and obj.get("kind"):
                objs.append(obj)
    return objs
