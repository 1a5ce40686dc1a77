"""In-process property graph with a Cypher-subset executor (the port's copy
of ``ragmeup_tpu/graph/store.py``: the same dialect, rows, schema and JSON).

The reference delegates GraphRAG to a Neo4j sidecar reached over HTTP
(``neo4j/server.py``; client calls at ``RAGHelper_cloud.py:424-513``,
``RAGHelper.py:568-710``). A single-process framework keeps the
graph in-process instead: this module implements the property-graph model
(labeled nodes / typed relationships with property maps) and executes the
Cypher dialect the reference's LLM prompts actually generate
(``.env.template:124-167`` few-shots):

    MERGE (q:Quote {text: $quoteText}) MERGE (t:Topic {name: $topicName})
    MERGE (q)-[:IS_PART_OF]->(t)
    MATCH (t:Topic) RETURN t.name
    MATCH (a:Person)-[:KNOWS]->(b) WHERE a.name = 'x' RETURN b.name LIMIT 5
    CREATE (n:Fact {name: 'y'})

Supported: MATCH / MERGE / CREATE clauses over node-rel-node paths, property
maps with ``$param`` / literal values, WHERE with =, <>, <, >, <=, >=,
AND/OR, RETURN [DISTINCT] of vars / var.prop / count(...), AS aliases,
ORDER BY, LIMIT. Unsupported syntax raises ``CypherError`` (callers treat
that like the reference treats Neo4j errors: log and continue).

Schema introspection matches the sidecar's ``GET /schema`` shape
(``neo4j/server.py:24-61``): labels with property keys + relationship types.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


class CypherError(Exception):
    pass


class Node:
    __slots__ = ("nid", "labels", "props")

    def __init__(self, nid: int, labels: frozenset, props: dict):
        self.nid = nid
        self.labels = labels
        self.props = props


class Rel:
    __slots__ = ("rid", "rtype", "start", "end", "props")

    def __init__(self, rid: int, rtype: str, start: int, end: int, props: dict):
        self.rid = rid
        self.rtype = rtype
        self.start = start
        self.end = end
        self.props = props


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<string>'(?:\\.|[^'\\])*'|"(?:\\.|[^"\\])*")
  | (?P<number>-?\d+\.\d+|-?\d+)
  | (?P<param>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<arrow><-|->|-)
  | (?P<punct>[(){}\[\],:.=]|<>|<=|>=|<|>)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
""", re.X)

_KEYWORDS = {"MATCH", "MERGE", "CREATE", "WHERE", "RETURN", "DISTINCT",
             "LIMIT", "AND", "OR", "AS", "ORDER", "BY", "DESC", "ASC",
             "TRUE", "FALSE", "NULL", "DELETE", "DETACH", "SET"}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise CypherError(f"unexpected character at {pos}: {text[pos:pos+10]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "word" and val.upper() in _KEYWORDS:
            out.append(("kw", val.upper()))
        else:
            out.append((kind, val))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# Parser (produces clause list)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, tokens, params):
        self.toks = tokens
        self.i = 0
        self.params = params or {}

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, val=None):
        t = self.next()
        if t[0] != kind or (val is not None and t[1] != val):
            raise CypherError(f"expected {val or kind}, got {t[1]!r}")
        return t

    def at_kw(self, *kws):
        t = self.peek()
        return t[0] == "kw" and t[1] in kws

    # -- values ---------------------------------------------------------------

    def parse_value(self):
        t = self.next()
        if t[0] == "string":
            return t[1][1:-1].replace("\\'", "'").replace('\\"', '"')
        if t[0] == "number":
            return float(t[1]) if "." in t[1] else int(t[1])
        if t[0] == "param":
            name = t[1][1:]
            if name not in self.params:
                raise CypherError(f"missing parameter ${name}")
            return self.params[name]
        if t[0] == "kw" and t[1] in ("TRUE", "FALSE"):
            return t[1] == "TRUE"
        if t[0] == "kw" and t[1] == "NULL":
            return None
        raise CypherError(f"expected value, got {t[1]!r}")

    def parse_props(self) -> dict:
        props = {}
        self.expect("punct", "{")
        while not (self.peek() == ("punct", "}")):
            key = self.next()
            if key[0] != "word":
                raise CypherError(f"expected property name, got {key[1]!r}")
            self.expect("punct", ":")
            props[key[1]] = self.parse_value()
            if self.peek() == ("punct", ","):
                self.next()
        self.expect("punct", "}")
        return props

    # -- patterns --------------------------------------------------------------

    def parse_node(self):
        self.expect("punct", "(")
        var = None
        labels = []
        props = {}
        if self.peek()[0] == "word":
            var = self.next()[1]
        while self.peek() == ("punct", ":"):
            self.next()
            labels.append(self.expect("word")[1])
        if self.peek() == ("punct", "{"):
            props = self.parse_props()
        self.expect("punct", ")")
        return {"var": var, "labels": labels, "props": props}

    def parse_rel(self):
        """Parse -[r:TYPE {..}]-> / <-[..]- / -[..]- between nodes."""
        t = self.next()
        if t == ("arrow", "<-"):
            direction = "left"
        elif t == ("arrow", "-"):
            direction = "pending"
        else:
            raise CypherError(f"expected relationship, got {t[1]!r}")
        var, rtype, props = None, None, {}
        if self.peek() == ("punct", "["):
            self.next()
            if self.peek()[0] == "word":
                var = self.next()[1]
            if self.peek() == ("punct", ":"):
                self.next()
                rtype = self.expect("word")[1]
            if self.peek() == ("punct", "{"):
                props = self.parse_props()
            self.expect("punct", "]")
        t = self.next()
        if t == ("arrow", "->"):
            if direction == "left":
                raise CypherError("invalid relationship direction")
            direction = "right"
        elif t == ("arrow", "-"):
            direction = "left" if direction == "left" else "both"
        else:
            raise CypherError(f"expected relationship end, got {t[1]!r}")
        return {"var": var, "type": rtype, "props": props, "dir": direction}

    def parse_pattern(self) -> List[dict]:
        """One path: node (rel node)*. Returns list of paths on commas."""
        paths = []
        while True:
            elems = [("node", self.parse_node())]
            while self.peek()[0] == "arrow":
                rel = self.parse_rel()
                node = self.parse_node()
                elems.append(("rel", rel))
                elems.append(("node", node))
            paths.append(elems)
            if self.peek() == ("punct", ","):
                self.next()
                continue
            break
        return paths

    # -- expressions -------------------------------------------------------------

    def parse_operand(self):
        t = self.peek()
        if t[0] == "word":
            var = self.next()[1]
            if var == "count" and self.peek() == ("punct", "("):
                self.next()
                inner = self.next()[1]  # var or *
                self.expect("punct", ")")
                return ("count", inner)
            if var in ("labels", "id") and self.peek() == ("punct", "("):
                self.next()
                inner = self.next()[1]
                self.expect("punct", ")")
                return ("fn", var, inner)
            if self.peek() == ("punct", "."):
                self.next()
                prop = self.expect("word")[1]
                return ("prop", var, prop)
            return ("var", var)
        return ("lit", self.parse_value())

    def parse_condition(self):
        left = self.parse_operand()
        op = self.next()
        if op[0] != "punct" or op[1] not in ("=", "<>", "<", ">", "<=", ">="):
            raise CypherError(f"expected comparison operator, got {op[1]!r}")
        right = self.parse_operand()
        cond = ("cmp", op[1], left, right)
        if self.at_kw("AND", "OR"):
            kw = self.next()[1]
            rest = self.parse_condition()
            return ("bool", kw, cond, rest)
        return cond

    # -- clauses ------------------------------------------------------------------

    def parse(self) -> List[dict]:
        clauses = []
        while not self.peek()[0] == "eof":
            if self.at_kw("MATCH"):
                self.next()
                paths = self.parse_pattern()
                where = None
                if self.at_kw("WHERE"):
                    self.next()
                    where = self.parse_condition()
                clauses.append({"kind": "match", "paths": paths, "where": where})
            elif self.at_kw("MERGE"):
                self.next()
                clauses.append({"kind": "merge", "paths": self.parse_pattern()})
            elif self.at_kw("CREATE"):
                self.next()
                clauses.append({"kind": "create", "paths": self.parse_pattern()})
            elif self.at_kw("RETURN"):
                self.next()
                distinct = False
                if self.at_kw("DISTINCT"):
                    self.next()
                    distinct = True
                items = []
                while True:
                    expr = self.parse_operand()
                    alias = None
                    if self.at_kw("AS"):
                        self.next()
                        alias = self.expect("word")[1]
                    items.append((expr, alias))
                    if self.peek() == ("punct", ","):
                        self.next()
                        continue
                    break
                order, desc, limit = None, False, None
                if self.at_kw("ORDER"):
                    self.next()
                    self.expect("kw", "BY")
                    order = self.parse_operand()
                    if self.at_kw("DESC"):
                        self.next()
                        desc = True
                    elif self.at_kw("ASC"):
                        self.next()
                if self.at_kw("LIMIT"):
                    self.next()
                    limit = int(self.parse_value())
                clauses.append({"kind": "return", "items": items,
                                "distinct": distinct, "order": order,
                                "desc": desc, "limit": limit})
            else:
                raise CypherError(f"unsupported clause at {self.peek()[1]!r}")
        return clauses


# ---------------------------------------------------------------------------
# Store + executor
# ---------------------------------------------------------------------------

class PropertyGraph:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.nodes: Dict[int, Node] = {}
        self.rels: Dict[int, Rel] = {}
        self._next_nid = 0
        self._next_rid = 0
        self._lock = threading.RLock()
        if path and os.path.exists(path):
            self._load(path)

    # -- primitive ops -----------------------------------------------------------

    def create_node(self, labels: Sequence[str], props: dict) -> Node:
        n = Node(self._next_nid, frozenset(labels), dict(props))
        self.nodes[n.nid] = n
        self._next_nid += 1
        return n

    def create_rel(self, rtype: str, start: int, end: int, props: dict) -> Rel:
        r = Rel(self._next_rid, rtype, start, end, dict(props))
        self.rels[r.rid] = r
        self._next_rid += 1
        return r

    def find_nodes(self, labels: Sequence[str], props: dict) -> List[Node]:
        out = []
        lset = set(labels)
        for n in self.nodes.values():
            if lset <= n.labels and all(n.props.get(k) == v
                                        for k, v in props.items()):
                out.append(n)
        return out

    # -- cypher ------------------------------------------------------------------

    def run(self, query: str, parameters: Optional[dict] = None) -> List[dict]:
        """Execute a Cypher query; returns RETURN rows as dicts (Neo4j
        driver ``data()`` shape, neo4j/server.py:63-75)."""
        with self._lock:
            clauses = _Parser(_tokenize(query), parameters).parse()
            bindings: List[Dict[str, Any]] = [{}]
            results: List[dict] = []
            for clause in clauses:
                if clause["kind"] == "match":
                    bindings = self._exec_match(clause, bindings)
                elif clause["kind"] == "merge":
                    bindings = self._exec_merge(clause, bindings)
                elif clause["kind"] == "create":
                    bindings = self._exec_create(clause, bindings)
                elif clause["kind"] == "return":
                    results = self._exec_return(clause, bindings)
            return results

    # match ---------------------------------------------------------------------

    def _exec_match(self, clause, bindings):
        out = []
        for binding in bindings:
            for bound in self._match_paths(clause["paths"], binding):
                if clause["where"] is None or self._eval_cond(clause["where"], bound):
                    out.append(bound)
        return out

    def _match_paths(self, paths, binding):
        results = [dict(binding)]
        for path in paths:
            new_results = []
            for b in results:
                new_results.extend(self._match_path(path, b))
            results = new_results
        return results

    def _match_path(self, elems, binding):
        """Backtracking match of node-rel-node chain."""
        def match_node(spec, b):
            var = spec["var"]
            if var and var in b and isinstance(b[var], Node):
                n = b[var]
                if set(spec["labels"]) <= n.labels and all(
                        n.props.get(k) == v for k, v in spec["props"].items()):
                    yield b, n
                return
            for n in self.find_nodes(spec["labels"], spec["props"]):
                nb = dict(b)
                if var:
                    nb[var] = n
                yield nb, n

        def walk(i, b, prev_node):
            if i >= len(elems):
                yield b
                return
            kind, spec = elems[i]
            if kind == "node":
                for nb, n in match_node(spec, b):
                    yield from walk(i + 1, nb, n)
            else:  # rel followed by node
                _, node_spec = elems[i + 1]
                for r in self.rels.values():
                    if spec["type"] and r.rtype != spec["type"]:
                        continue
                    if not all(r.props.get(k) == v
                               for k, v in spec["props"].items()):
                        continue
                    candidates = []
                    if spec["dir"] in ("right", "both") and r.start == prev_node.nid:
                        candidates.append(r.end)
                    if spec["dir"] in ("left", "both") and r.end == prev_node.nid:
                        candidates.append(r.start)
                    for other_id in candidates:
                        other = self.nodes[other_id]
                        if not (set(node_spec["labels"]) <= other.labels):
                            continue
                        if not all(other.props.get(k) == v
                                   for k, v in node_spec["props"].items()):
                            continue
                        nb = dict(b)
                        if spec["var"]:
                            nb[spec["var"]] = r
                        nvar = node_spec["var"]
                        if nvar:
                            if nvar in nb and isinstance(nb[nvar], Node):
                                if nb[nvar].nid != other.nid:
                                    continue
                            nb[nvar] = other
                        yield from walk(i + 2, nb, other)

        yield from walk(0, dict(binding), None)

    # merge / create -------------------------------------------------------------

    def _materialize_path(self, elems, binding, merge: bool):
        b = dict(binding)
        prev = None
        pending_rel = None
        for kind, spec in elems:
            if kind == "node":
                node = None
                var = spec["var"]
                if var and var in b and isinstance(b[var], Node):
                    node = b[var]
                else:
                    if merge:
                        found = self.find_nodes(spec["labels"], spec["props"])
                        node = found[0] if found else None
                    if node is None:
                        node = self.create_node(spec["labels"], spec["props"])
                    if var:
                        b[var] = node
                if pending_rel is not None:
                    rel_spec = pending_rel
                    start, end = prev, node
                    if rel_spec["dir"] == "left":
                        start, end = node, prev
                    existing = None
                    if merge:
                        for r in self.rels.values():
                            if (r.rtype == rel_spec["type"] and
                                    r.start == start.nid and r.end == end.nid and
                                    all(r.props.get(k) == v
                                        for k, v in rel_spec["props"].items())):
                                existing = r
                                break
                    if existing is None:
                        existing = self.create_rel(rel_spec["type"] or "RELATED",
                                                   start.nid, end.nid,
                                                   rel_spec["props"])
                    if rel_spec["var"]:
                        b[rel_spec["var"]] = existing
                    pending_rel = None
                prev = node
            else:
                pending_rel = spec
        return b

    def _exec_merge(self, clause, bindings):
        return [self._materialize_path(path, b, merge=True)
                for b in bindings for path in [p for p in clause["paths"]]] \
            if len(clause["paths"]) == 1 else \
            [self._merge_multi(clause["paths"], b) for b in bindings]

    def _merge_multi(self, paths, b):
        for path in paths:
            b = self._materialize_path(path, b, merge=True)
        return b

    def _exec_create(self, clause, bindings):
        out = []
        for b in bindings:
            for path in clause["paths"]:
                b = self._materialize_path(path, b, merge=False)
            out.append(b)
        return out

    # return ---------------------------------------------------------------------

    def _eval_operand(self, expr, b):
        kind = expr[0]
        if kind == "lit":
            return expr[1]
        if kind == "var":
            v = b.get(expr[1])
            if isinstance(v, Node):
                return dict(v.props)
            if isinstance(v, Rel):
                return dict(v.props)
            return v
        if kind == "prop":
            v = b.get(expr[1])
            if isinstance(v, (Node, Rel)):
                return v.props.get(expr[2])
            return None
        if kind == "fn":
            fn, var = expr[1], expr[2]
            v = b.get(var)
            if fn == "labels" and isinstance(v, Node):
                return sorted(v.labels)
            if fn == "id" and isinstance(v, (Node, Rel)):
                return v.nid if isinstance(v, Node) else v.rid
            return None
        raise CypherError(f"cannot evaluate {expr}")

    def _eval_cond(self, cond, b) -> bool:
        if cond[0] == "bool":
            l = self._eval_cond(cond[2], b)
            r = self._eval_cond(cond[3], b)
            return (l and r) if cond[1] == "AND" else (l or r)
        _, op, le, re_ = cond
        lv, rv = self._eval_operand(le, b), self._eval_operand(re_, b)
        try:
            if op == "=":
                return lv == rv
            if op == "<>":
                return lv != rv
            if lv is None or rv is None:
                return False
            if op == "<":
                return lv < rv
            if op == ">":
                return lv > rv
            if op == "<=":
                return lv <= rv
            if op == ">=":
                return lv >= rv
        except TypeError:
            return False
        return False

    def _exec_return(self, clause, bindings):
        rows = []
        counting = any(it[0][0] == "count" for it in clause["items"])
        if counting:
            expr, alias = clause["items"][0]
            name = alias or f"count({expr[1]})"
            return [{name: len(bindings)}]
        for b in bindings:
            row = {}
            for expr, alias in clause["items"]:
                if alias:
                    name = alias
                elif expr[0] == "prop":
                    name = f"{expr[1]}.{expr[2]}"
                elif expr[0] == "var":
                    name = expr[1]
                elif expr[0] == "fn":
                    name = f"{expr[1]}({expr[2]})"
                else:
                    name = "value"
                row[name] = self._eval_operand(expr, b)
            rows.append(row)
        if clause["distinct"]:
            seen = set()
            uniq = []
            for r in rows:
                key = json.dumps(r, sort_keys=True, default=str)
                if key not in seen:
                    seen.add(key)
                    uniq.append(r)
            rows = uniq
        if clause["order"] is not None:
            # re-evaluate order key per row is not possible post-projection for
            # props not projected; sort on projected value when present
            def key(r):
                expr = clause["order"]
                if expr[0] == "prop":
                    return r.get(f"{expr[0+1]}.{expr[2]}") or 0
                return 0
            rows.sort(key=key, reverse=clause["desc"])
        if clause["limit"] is not None:
            rows = rows[:clause["limit"]]
        return rows

    # -- schema (sidecar GET /schema shape) -----------------------------------------

    def schema(self) -> dict:
        labels: Dict[str, set] = {}
        for n in self.nodes.values():
            for lb in n.labels:
                labels.setdefault(lb, set()).update(n.props.keys())
        rel_types: Dict[str, set] = {}
        for r in self.rels.values():
            rel_types.setdefault(r.rtype, set()).update(r.props.keys())
        return {
            "node_labels": [{"label": lb, "properties": sorted(props)}
                            for lb, props in sorted(labels.items())],
            "relationship_types": [{"type": t, "properties": sorted(props)}
                                   for t, props in sorted(rel_types.items())],
        }

    # -- batch write (sidecar POST /add_instances shape) ------------------------------

    def add_instances(self, instances: Sequence[dict]) -> int:
        """[{query, parameters}] write batch (neo4j/server.py:131-140)."""
        count = 0
        for inst in instances:
            self.run(inst["query"], inst.get("parameters"))
            count += 1
        if self.path:
            self.save()
        return count

    # -- persistence ---------------------------------------------------------------------

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            return
        data = {
            "nodes": [{"id": n.nid, "labels": sorted(n.labels), "props": n.props}
                      for n in self.nodes.values()],
            "rels": [{"id": r.rid, "type": r.rtype, "start": r.start,
                      "end": r.end, "props": r.props}
                     for r in self.rels.values()],
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(data, f)

    def _load(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        for nd in data["nodes"]:
            self.nodes[nd["id"]] = Node(nd["id"], frozenset(nd["labels"]),
                                        nd["props"])
            self._next_nid = max(self._next_nid, nd["id"] + 1)
        for rd in data["rels"]:
            self.rels[rd["id"]] = Rel(rd["id"], rd["type"], rd["start"],
                                      rd["end"], rd["props"])
            self._next_rid = max(self._next_rid, rd["id"] + 1)
