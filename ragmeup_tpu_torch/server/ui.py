"""Web UI: chat SPA + document management + feedback persistence.

Parity with the reference's Scala Play UI (SURVEY.md §2.2 #11-13,
``ui/scala/``) as an in-process page set on the same WSGI server
(``server/wsgi.py``); the port's copy of ``ragmeup_tpu/server/ui.py``, its
pages byte for byte:

- chat page keeps ``chathistory``, ``documents`` and a session id
  client-side and round-trips them through every request — the server stays
  stateless (``index.scala.html:46-48``);
- retrieved documents render with their provenance score and expandable
  content (``index.scala.html:123-214``); a "rewritten" notice shows when
  the query-rewrite loop fired (``:241-244``);
- thumbs up/down feedback posts to ``/feedback``; unlike the reference
  (stubbed end-to-end: ``HomeController.scala:155-157``) feedback and chat
  logs are actually persisted, into SQLite with the Scala schema's shape
  (``conf/evolutions/ragmeup/1.sql``: chat_logs + feedback);
- ``/add`` lists documents with download/delete and a multipart upload form
  (``add.scala.html``).

Markdown rendering is a small self-contained JS renderer (the reference
pulls showdown from a CDN — zero-egress deployments can't).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS chat_logs (
    id TEXT NOT NULL,
    message_offset INTEGER NOT NULL,
    text TEXT, role TEXT, reply TEXT, documents TEXT,
    rewritten INTEGER, question TEXT, fetched_new_documents INTEGER,
    ts REAL,
    PRIMARY KEY (id, message_offset)
);
CREATE TABLE IF NOT EXISTS feedback (
    chat_id TEXT NOT NULL,
    message_offset INTEGER NOT NULL,
    feedback INTEGER,
    ts REAL,
    PRIMARY KEY (chat_id, message_offset)
);
"""


class FeedbackStore:
    """SQLite persistence for chat logs + feedback (SQLTables.scala shape)."""

    def __init__(self, path: str = "ui.db"):
        self.path = path
        self._lock = threading.Lock()
        with self._conn() as c:
            c.executescript(_SCHEMA)

    def _conn(self):
        return sqlite3.connect(self.path)

    def log_chat(self, session_id: str, offset: int, text: str, role: str,
                 reply: str, documents, rewritten: bool, question: str,
                 fetched_new: bool) -> None:
        with self._lock, self._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO chat_logs VALUES (?,?,?,?,?,?,?,?,?,?)",
                (session_id, offset, text, role, reply,
                 json.dumps(documents), int(rewritten), question,
                 int(fetched_new), time.time()))

    def add_feedback(self, chat_id: str, offset: int, feedback: int) -> None:
        with self._lock, self._conn() as c:
            c.execute("INSERT OR REPLACE INTO feedback VALUES (?,?,?,?)",
                      (chat_id, offset, feedback, time.time()))

    def get_feedback(self, chat_id: Optional[str] = None):
        with self._lock, self._conn() as c:
            if chat_id:
                rows = c.execute(
                    "SELECT chat_id, message_offset, feedback FROM feedback "
                    "WHERE chat_id = ?", (chat_id,)).fetchall()
            else:
                rows = c.execute(
                    "SELECT chat_id, message_offset, feedback FROM feedback"
                ).fetchall()
        return [{"chat_id": r[0], "message_offset": r[1], "feedback": r[2]}
                for r in rows]


_CSS = """
:root { --bg:#111418; --panel:#1b2026; --text:#e6e9ed; --dim:#9aa4af;
        --accent:#4f8cff; --good:#37b26c; --bad:#e05d5d; }
* { box-sizing: border-box; }
body { margin:0; font:15px/1.5 system-ui,sans-serif; background:var(--bg);
       color:var(--text); }
header { padding:12px 20px; background:var(--panel); display:flex;
         justify-content:space-between; align-items:center; }
header a { color:var(--accent); text-decoration:none; margin-left:16px; }
main { max-width: 880px; margin: 0 auto; padding: 16px; }
.msg { margin:10px 0; padding:12px 14px; border-radius:10px; white-space:normal; }
.msg.user { background:#24324a; margin-left:15%; }
.msg.assistant { background:var(--panel); margin-right:15%; }
.msg .meta { color:var(--dim); font-size:12px; margin-bottom:4px;
             display:flex; justify-content:space-between; }
.rewritten { color:#e0b84f; font-size: 13px; margin: 4px 0; }
.doc { border:1px solid #2a323c; border-radius:8px; margin:6px 0; }
.doc summary { cursor:pointer; padding:8px 10px; color:var(--dim); }
.doc .prov { color:var(--accent); margin-left:8px; }
.doc pre { margin:0; padding:10px; white-space:pre-wrap; color:var(--text);
           font-size: 13px; }
#bar { display:flex; gap:8px; margin-top:12px; }
#prompt { flex:1; padding:12px; border-radius:8px; border:1px solid #2a323c;
          background:var(--panel); color:var(--text); font-size:15px; }
button { padding:10px 16px; border-radius:8px; border:0;
         background:var(--accent); color:white; cursor:pointer; }
button.fb { background:transparent; font-size:14px; padding:2px 6px; }
table { width:100%; border-collapse:collapse; }
td, th { padding:8px 10px; border-bottom:1px solid #2a323c; text-align:left; }
.flash { padding:10px; border-radius:8px; margin:10px 0; }
.flash.ok { background:#1d3a2a; } .flash.err { background:#46262a; }
code { background:#0d1013; padding:1px 5px; border-radius:4px; }
pre.code { background:#0d1013; padding:10px; border-radius:8px;
           overflow-x:auto; }
#spinner { color: var(--dim); display:none; }
"""

_MD_JS = """
function mdRender(t) {
  t = t.replace(/&/g,'&amp;').replace(/</g,'&lt;').replace(/>/g,'&gt;');
  t = t.replace(/```([\\s\\S]*?)```/g, (m, c) => '<pre class="code">'+c+'</pre>');
  t = t.replace(/`([^`]+)`/g, '<code>$1</code>');
  t = t.replace(/\\*\\*([^*]+)\\*\\*/g, '<b>$1</b>');
  t = t.replace(/\\*([^*]+)\\*/g, '<i>$1</i>');
  t = t.replace(/\\[([^\\]]+)\\]\\(([^)]+)\\)/g,
                '<a href="$2" target="_blank">$1</a>');
  t = t.replace(/^### (.*)$/gm, '<h4>$1</h4>');
  t = t.replace(/^## (.*)$/gm, '<h3>$1</h3>');
  t = t.replace(/^- (.*)$/gm, '<li>$1</li>');
  return t.replace(/\\n\\n/g, '<br><br>').replace(/\\n/g, '<br>');
}
"""

_CHAT_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ragmeup-tpu</title>
<style>{css}</style></head>
<body>
<header><b>ragmeup-tpu</b>
  <nav><a href="/">Chat</a><a href="/add">Documents</a></nav></header>
<main>
  <div id="chat"></div>
  <div id="spinner">thinking…</div>
  <div id="bar">
    <input id="prompt" placeholder="Ask the librarian…"
           onkeydown="if(event.key==='Enter')send()">
    <button onclick="send()">Send</button>
    <button onclick="resetChat()" style="background:#2a323c">Reset</button>
  </div>
</main>
<script>
{mdjs}
let chathistory = [];
let documents = [];
let sessionid = 's-' + Math.random().toString(36).slice(2);
let offset = 0;

function docHtml(d) {
  const prov = (d.provenance !== undefined)
    ? '<span class="prov">provenance: ' + Number(d.provenance).toFixed(3) + '</span>' : '';
  return '<details class="doc"><summary>' + d.s + prov +
         '</summary><pre>' + d.c.replace(/</g,'&lt;') + '</pre></details>';
}

function feedback(off, val, btn) {
  fetch('/feedback', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({chat_id: sessionid, message_offset: off, feedback: val})});
  btn.textContent = val > 0 ? '✔👍' : '✔👎';
}

function addMsg(role, html, off) {
  const div = document.createElement('div');
  div.className = 'msg ' + role;
  let fb = '';
  if (role === 'assistant') {
    fb = '<span><button class="fb" onclick="feedback(' + off + ',1,this)">👍</button>' +
         '<button class="fb" onclick="feedback(' + off + ',-1,this)">👎</button></span>';
  }
  div.innerHTML = '<div class="meta"><span>' + role + '</span>' + fb + '</div>' + html;
  document.getElementById('chat').appendChild(div);
  div.scrollIntoView();
}

async function send() {
  const input = document.getElementById('prompt');
  const q = input.value.trim();
  if (!q) return;
  input.value = '';
  addMsg('user', mdRender(q), offset++);
  document.getElementById('spinner').style.display = 'block';
  try {
    const r = await fetch('/search', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({query: q, history: chathistory, docs: documents,
                            session_id: sessionid})});
    const data = await r.json();
    chathistory = data.history;
    documents = data.documents;
    let html = '';
    if (data.rewritten) {
      html += '<div class="rewritten">query rewritten to: "' + data.question + '"</div>';
    }
    html += mdRender(data.reply);
    if (data.fetched_new_documents && data.documents.length) {
      html += '<div>' + data.documents.map(docHtml).join('') + '</div>';
    }
    addMsg('assistant', html, offset++);
  } catch (e) {
    addMsg('assistant', 'Something went wrong: ' + e, offset++);
  }
  document.getElementById('spinner').style.display = 'none';
}

function resetChat() {
  chathistory = []; documents = []; offset = 0;
  document.getElementById('chat').innerHTML = '';
}
</script>
</body></html>
"""

_ADD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ragmeup-tpu — documents</title>
<style>{css}</style></head>
<body>
<header><b>ragmeup-tpu</b>
  <nav><a href="/">Chat</a><a href="/add">Documents</a></nav></header>
<main>
  <div id="flash"></div>
  <h3>Upload document</h3>
  <form id="up" enctype="multipart/form-data">
    <input type="file" name="file" required>
    <button type="submit">Upload</button>
  </form>
  <h3>Indexed documents</h3>
  <table id="docs"><tr><th>File</th><th></th><th></th></tr></table>
</main>
<script>
async function refresh() {
  const files = await (await fetch('/get_documents')).json();
  const table = document.getElementById('docs');
  table.innerHTML = '<tr><th>File</th><th></th><th></th></tr>';
  for (const f of files) {
    const tr = document.createElement('tr');
    tr.innerHTML = '<td>' + f + '</td>' +
      '<td><button onclick="dl(\\'' + f + '\\')">download</button></td>' +
      '<td><button style="background:var(--bad)" onclick="del(\\'' + f +
      '\\')">delete</button></td>';
    table.appendChild(tr);
  }
}
function flash(msg, ok) {
  document.getElementById('flash').innerHTML =
    '<div class="flash ' + (ok ? 'ok' : 'err') + '">' + msg + '</div>';
}
async function dl(f) {
  const r = await fetch('/get_document', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({filename: f})});
  const blob = await r.blob();
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob); a.download = f; a.click();
}
async function del(f) {
  const r = await fetch('/delete', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({filename: f})});
  const data = await r.json();
  flash(r.ok ? 'Deleted ' + f + ' (' + data.count + ' chunks)' :
        'Delete failed: ' + data.error, r.ok);
  refresh();
}
document.getElementById('up').onsubmit = async (e) => {
  e.preventDefault();
  const fd = new FormData(e.target);
  flash('Uploading…', true);
  const r = await fetch('/add_document', {method:'POST', body: fd});
  const data = await r.json();
  flash(r.ok ? 'Indexed ' + data.filename + ' (' + data.chunks + ' chunks)' :
        'Upload failed: ' + data.error, r.ok);
  refresh();
};
refresh();
</script>
</body></html>
"""


def chat_page() -> str:
    return _CHAT_HTML.replace("{css}", _CSS).replace("{mdjs}", _MD_JS)


def add_page() -> str:
    return _ADD_HTML.replace("{css}", _CSS)
