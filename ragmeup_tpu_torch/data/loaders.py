"""File loaders for ingestion.

Covers the reference's loader matrix (``server/RAGHelper.py:204-297``):
pdf, json (jq-style schema), csv, docx, xlsx, pptx, xml (XPath), txt — plus
md. The reference delegates to pypdf/docx2txt/openpyxl/python-pptx/jq via
LangChain loaders; here the Office formats are parsed directly (they are
zip+XML), PDF gets a self-contained text extractor, and a minimal jq-subset
evaluator handles the json schema knob. All loaders are host-side (not
perf-critical; SURVEY.md §2.3).
"""

from __future__ import annotations

import csv as _csv
import io
import json as _json
import os
import re
import zipfile
import zlib
from typing import Iterable, List, Optional

from ragmeup_tpu_torch.data.documents import Chunk

try:
    from lxml import etree as _etree
except ImportError:  # pragma: no cover
    _etree = None


# ---------------------------------------------------------------------------
# Plain text
# ---------------------------------------------------------------------------

def load_txt(path: str) -> List[Chunk]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return [Chunk(content=f.read(), metadata={"source": path})]


# ---------------------------------------------------------------------------
# CSV — one document per row (reference CSVLoader semantics)
# ---------------------------------------------------------------------------

def load_csv(path: str) -> List[Chunk]:
    out: List[Chunk] = []
    with open(path, "r", encoding="utf-8", errors="replace", newline="") as f:
        reader = _csv.DictReader(f)
        if reader.fieldnames is None:
            return out
        for i, row in enumerate(reader):
            content = "\n".join(f"{k}: {v}" for k, v in row.items() if v is not None)
            out.append(Chunk(content=content, metadata={"source": path, "row": i}))
    return out


# ---------------------------------------------------------------------------
# JSON — jq-subset schema evaluation (reference: JSONLoader with jq_schema,
# RAGHelper.py:114-131; knobs json_schema / json_text_content)
# ---------------------------------------------------------------------------

_JQ_TOKEN = re.compile(r"\.(?P<field>[A-Za-z_][A-Za-z0-9_]*)|\[(?P<index>\d*)\]")


def eval_jq(schema: str, data):
    """Evaluate a jq-subset path: '.', '.a', '.a.b', '.a[]', '.[]', '.a[0]'.
    Returns a list of matched values."""
    schema = schema.strip()
    vals = [data]
    if schema in (".", ""):
        return vals
    pos = 0
    if schema[0] != ".":
        raise ValueError(f"unsupported jq schema: {schema}")
    for m in _JQ_TOKEN.finditer(schema):
        if m.start() != pos:
            raise ValueError(f"unsupported jq schema: {schema}")
        pos = m.end()
        nxt = []
        if m.group("field") is not None:
            for v in vals:
                if isinstance(v, dict) and m.group("field") in v:
                    nxt.append(v[m.group("field")])
        elif m.group("index") == "":
            for v in vals:
                if isinstance(v, list):
                    nxt.extend(v)
        else:
            idx = int(m.group("index"))
            for v in vals:
                if isinstance(v, list) and idx < len(v):
                    nxt.append(v[idx])
        vals = nxt
    if pos != len(schema):
        raise ValueError(f"unsupported jq schema: {schema}")
    return vals


def load_json(path: str, schema: str = ".", text_content: bool = False) -> List[Chunk]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        data = _json.load(f)
    out: List[Chunk] = []
    for i, v in enumerate(eval_jq(schema, data)):
        if text_content and not isinstance(v, str):
            continue
        content = v if isinstance(v, str) else _json.dumps(v, ensure_ascii=False)
        out.append(Chunk(content=content, metadata={"source": path, "seq_num": i}))
    return out


# ---------------------------------------------------------------------------
# XML — XPath per-element documents (reference RAGHelper.py:133-165)
# ---------------------------------------------------------------------------

def load_xml(path: str, xpath: str = "//*") -> List[Chunk]:
    if _etree is None:  # pragma: no cover
        raise RuntimeError("lxml is required for XML ingestion")
    tree = _etree.parse(path)
    out: List[Chunk] = []
    for i, el in enumerate(tree.xpath(xpath)):
        text = _etree.tostring(el, method="text", encoding="unicode").strip()
        if text:
            out.append(Chunk(content=text, metadata={"source": path, "element": i,
                                                     "tag": str(getattr(el, "tag", ""))}))
    return out


# ---------------------------------------------------------------------------
# Office Open XML (docx / xlsx / pptx) — zip + XML, parsed directly
# ---------------------------------------------------------------------------

_WT_RE = re.compile(rb"<w:t(?:\s[^>]*)?>(.*?)</w:t>", re.S)
_WP_END = re.compile(rb"</w:p>")
_AT_RE = re.compile(rb"<a:t(?:\s[^>]*)?>(.*?)</a:t>", re.S)
_XML_UNESCAPE = [(b"&lt;", b"<"), (b"&gt;", b">"), (b"&quot;", b'"'),
                 (b"&apos;", b"'"), (b"&amp;", b"&")]


def _unescape(b: bytes) -> str:
    for k, v in _XML_UNESCAPE:
        b = b.replace(k, v)
    return b.decode("utf-8", errors="replace")


def load_docx(path: str) -> List[Chunk]:
    with zipfile.ZipFile(path) as z:
        xml = z.read("word/document.xml")
    paras = []
    for para in _WP_END.split(xml):
        runs = [_unescape(m.group(1)) for m in _WT_RE.finditer(para)]
        if runs:
            paras.append("".join(runs))
    return [Chunk(content="\n".join(paras), metadata={"source": path})]


def load_pptx(path: str) -> List[Chunk]:
    out: List[Chunk] = []
    with zipfile.ZipFile(path) as z:
        slides = sorted(n for n in z.namelist()
                        if re.fullmatch(r"ppt/slides/slide\d+\.xml", n))
        for i, name in enumerate(slides):
            xml = z.read(name)
            texts = [_unescape(m.group(1)) for m in _AT_RE.finditer(xml)]
            content = "\n".join(t for t in texts if t.strip())
            if content:
                out.append(Chunk(content=content, metadata={"source": path, "slide": i + 1}))
    return out


def _xlsx_shared_strings(z: zipfile.ZipFile) -> List[str]:
    try:
        xml = z.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    if _etree is not None:
        root = _etree.fromstring(xml)
        ns = {"m": root.nsmap.get(None, "")}
        out = []
        for si in root:
            out.append("".join(t.text or "" for t in si.iter() if t.tag.endswith("}t") or t.tag == "t"))
        return out
    return [_unescape(m.group(1)) for m in re.finditer(rb"<t(?:\s[^>]*)?>(.*?)</t>", xml, re.S)]


def load_xlsx(path: str) -> List[Chunk]:
    out: List[Chunk] = []
    with zipfile.ZipFile(path) as z:
        shared = _xlsx_shared_strings(z)
        sheets = sorted(n for n in z.namelist()
                        if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n))
        for name in sheets:
            xml = z.read(name)
            rows = []
            for rm in re.finditer(rb"<row[^>]*>(.*?)</row>", xml, re.S):
                cells = []
                for cm in re.finditer(rb'<c([^>]*)>(.*?)</c>', rm.group(1), re.S):
                    attrs, body = cm.group(1), cm.group(2)
                    vm = re.search(rb"<v>(.*?)</v>", body, re.S)
                    if vm is None:
                        tm = re.search(rb"<t(?:\s[^>]*)?>(.*?)</t>", body, re.S)
                        cells.append(_unescape(tm.group(1)) if tm else "")
                        continue
                    val = _unescape(vm.group(1))
                    if b't="s"' in attrs:
                        try:
                            val = shared[int(val)]
                        except (ValueError, IndexError):
                            pass
                    cells.append(val)
                if any(c.strip() for c in cells):
                    rows.append("\t".join(cells))
            if rows:
                out.append(Chunk(content="\n".join(rows),
                                 metadata={"source": path, "sheet": name.rsplit("/", 1)[-1]}))
    return out


# ---------------------------------------------------------------------------
# PDF — minimal self-contained text extractor (replaces pypdf dependency).
# Handles FlateDecode content streams, BT/ET text blocks, Tj/TJ/' operators,
# literal () strings with escapes and <> hex strings. CID/Type0 subset fonts
# with custom encodings degrade to per-byte text (documented limitation).
# ---------------------------------------------------------------------------

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.S)
_TEXT_SHOW_RE = re.compile(
    rb"(\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]*>)\s*(Tj|')"  # single show
    rb"|\[((?:\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]*>|[-0-9.\s])*)\]\s*TJ",  # array show
    re.S)
_PDF_ESCAPES = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b",
                b"f": b"\f", b"(": b"(", b")": b")", b"\\": b"\\"}


def _decode_pdf_string(raw: bytes) -> str:
    if raw.startswith(b"<"):
        hexstr = re.sub(rb"\s", b"", raw[1:-1])
        if len(hexstr) % 2:
            hexstr += b"0"
        data = bytes.fromhex(hexstr.decode("ascii", errors="ignore"))
        # Heuristic: UTF-16BE BOM or 2-byte CID text
        if data[:2] == b"\xfe\xff":
            return data[2:].decode("utf-16-be", errors="replace")
        if len(data) % 2 == 0 and all(b == 0 for b in data[::2]) and len(data) > 0:
            return data[1::2].decode("latin-1", errors="replace")
        return data.decode("latin-1", errors="replace")
    # literal string
    body = raw[1:-1]
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i:i + 1]
        if c == b"\\" and i + 1 < len(body):
            nxt = body[i + 1:i + 2]
            if nxt in _PDF_ESCAPES:
                out += _PDF_ESCAPES[nxt]
                i += 2
            elif nxt.isdigit():
                oct_digits = body[i + 1:i + 4]
                m = re.match(rb"[0-7]{1,3}", oct_digits)
                out.append(int(m.group(0), 8) & 0xFF)
                i += 1 + len(m.group(0))
            else:
                i += 1
        else:
            out += c
            i += 1
    return out.decode("latin-1", errors="replace")


def _extract_stream_text(data: bytes) -> str:
    parts: List[str] = []
    for m in _TEXT_SHOW_RE.finditer(data):
        if m.group(1) is not None:
            parts.append(_decode_pdf_string(m.group(1)))
            if m.group(2) == b"'":
                parts.append("\n")
        else:
            arr = m.group(3) or b""
            for sm in re.finditer(rb"\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]*>", arr, re.S):
                parts.append(_decode_pdf_string(sm.group(0)))
            parts.append("")
    # approximate line structure from text-positioning operators
    return "".join(parts)


def extract_pdf_text(path: str) -> str:
    with open(path, "rb") as f:
        raw = f.read()
    texts: List[str] = []
    for m in _STREAM_RE.finditer(raw):
        data = m.group(1)
        # try flate; fall back to raw if it is an uncompressed stream
        try:
            data = zlib.decompress(data)
        except zlib.error:
            try:
                data = zlib.decompress(data, -15)
            except zlib.error:
                pass
        if b"BT" in data and b"ET" in data:
            t = _extract_stream_text(data)
            if t.strip():
                texts.append(t)
    return "\n".join(texts)


def load_pdf(path: str) -> List[Chunk]:
    text = extract_pdf_text(path)
    return [Chunk(content=text, metadata={"source": path})] if text.strip() else []


# ---------------------------------------------------------------------------
# Dispatch (parity with RAGHelper._load_document, RAGHelper.py:272-297)
# ---------------------------------------------------------------------------

def load_file(path: str, json_schema: str = ".", json_text_content: bool = False,
              xml_xpath: str = "//*") -> List[Chunk]:
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in ("txt", "md", "rst", "text", "log"):
        return load_txt(path)
    if ext == "csv":
        return load_csv(path)
    if ext == "json" or ext == "jsonl":
        if ext == "jsonl":
            out: List[Chunk] = []
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                for i, line in enumerate(f):
                    if not line.strip():
                        continue
                    for v in eval_jq(json_schema, _json.loads(line)):
                        content = v if isinstance(v, str) else _json.dumps(v, ensure_ascii=False)
                        out.append(Chunk(content=content, metadata={"source": path, "seq_num": i}))
            return out
        return load_json(path, json_schema, json_text_content)
    if ext == "xml":
        return load_xml(path, xml_xpath)
    if ext == "docx":
        return load_docx(path)
    if ext == "pptx":
        return load_pptx(path)
    if ext in ("xlsx", "xslx"):  # the reference's template typos 'xslx'
        return load_xlsx(path)
    if ext == "pdf":
        return load_pdf(path)
    raise ValueError(f"unsupported file type: {ext} ({path})")


def load_directory(data_dir: str, file_types: Iterable[str],
                   json_schema: str = ".", json_text_content: bool = False,
                   xml_xpath: str = "//*",
                   on_error: Optional[callable] = None) -> List[Chunk]:
    """Load every matching file under ``data_dir`` (recursive), tolerating
    per-file failures like the reference (RAGHelper.py:267-268)."""
    exts = {t.lower().lstrip(".") for t in file_types}
    if "xslx" in exts:
        exts.add("xlsx")
    out: List[Chunk] = []
    for root, _dirs, files in os.walk(data_dir):
        for name in sorted(files):
            ext = os.path.splitext(name)[1].lower().lstrip(".")
            if ext not in exts:
                continue
            path = os.path.join(root, name)
            try:
                out.extend(load_file(path, json_schema, json_text_content, xml_xpath))
            except Exception as e:  # noqa: BLE001 — per-file tolerance
                if on_error is not None:
                    on_error(path, e)
    return out
