"""Chat LLM backends.

The pipeline talks to one ``ChatBackend`` protocol: ``chat(messages) -> str``
over role/content dicts. Backends:

- ``LocalChatBackend`` — the in-process JAX decoder (``models/decoder.py``),
  replacing the reference's HF pipeline path (``RAGHelper_local.py:91-105``);
  applies a Llama-3-style chat template and strips the reply after the
  assistant token (``RAGHelper_local.py:266-271`` semantics).
- ``CloudChatBackend`` — OpenAI / Azure / Gemini / Ollama HTTP adapters with
  the reference's selection flags (``RAGHelper_cloud.py:60-88``). Zero-egress
  environments simply never enable these.
- ``StaticChatBackend`` — scriptable responses for tests and offline evals.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

Message = Dict[str, str]  # {"role": ..., "content": ...}


class ChatBackend:
    def chat(self, messages: List[Message], max_new_tokens: int = 1000,
             temperature: float = 0.2, repetition_penalty: float = 1.1) -> str:
        raise NotImplementedError

    def complete(self, prompt: str, **kw) -> str:
        return self.chat([{"role": "user", "content": prompt}], **kw)


def llama3_template(messages: List[Message]) -> str:
    """Llama-3-instruct-style chat template (generic enough for any decoder:
    role headers + end-of-turn markers)."""
    parts = ["<|begin_of_text|>"]
    for m in messages:
        parts.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                     f"{m['content']}<|eot_id|>")
    parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(parts)


def _special_token(value) -> str:
    """tokenizer_config special tokens are either strings or
    {"content": ..., ...} AddedToken dicts."""
    if isinstance(value, dict):
        return str(value.get("content", ""))
    return str(value) if value is not None else ""


def hf_chat_template(checkpoint_dir: Optional[str]) -> Optional[Callable]:
    """Build a chat-template callable from a checkpoint's own template,
    exactly as ``tokenizer.apply_chat_template`` would (parity with the
    reference's prompt assembly, RAGHelper_local.py:246-249). Sources, in
    precedence order: ``chat_template.jinja``, ``chat_template.json``,
    ``tokenizer_config.json``'s ``chat_template`` (string or named list).
    Returns None when the checkpoint ships no template (caller falls back
    to ``llama3_template``)."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    source = None
    cfg = {}
    tc = os.path.join(checkpoint_dir, "tokenizer_config.json")
    if os.path.exists(tc):
        with open(tc) as f:
            cfg = json.load(f)
    jinja_file = os.path.join(checkpoint_dir, "chat_template.jinja")
    json_file = os.path.join(checkpoint_dir, "chat_template.json")
    if os.path.exists(jinja_file):
        with open(jinja_file) as f:
            source = f.read()
    elif os.path.exists(json_file):
        with open(json_file) as f:
            source = json.load(f).get("chat_template")
    else:
        source = cfg.get("chat_template")
    if isinstance(source, list):  # named templates: use "default"
        by_name = {d.get("name"): d.get("template") for d in source}
        source = by_name.get("default") or next(iter(by_name.values()), None)
    if not source:
        return None

    import datetime
    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def strftime_now(fmt):
        return datetime.datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = lambda x, **kw: json.dumps(x, **kw)
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    compiled = env.from_string(source)
    special = {
        "bos_token": _special_token(cfg.get("bos_token")),
        "eos_token": _special_token(cfg.get("eos_token")),
        "unk_token": _special_token(cfg.get("unk_token")),
        "pad_token": _special_token(cfg.get("pad_token")),
    }

    def template(messages: List[Message]) -> str:
        return compiled.render(messages=messages, add_generation_prompt=True,
                               tools=None, **special)

    return template


def resolve_chat_template(checkpoint_dir: Optional[str]) -> Callable:
    """The checkpoint's own chat template when it ships one, else the
    generic Llama-3-style fallback."""
    return hf_chat_template(checkpoint_dir) or llama3_template


class LocalChatBackend(ChatBackend):
    def __init__(self, llm, template: Callable[[List[Message]], str] = llama3_template,
                 assistant_token: Optional[str] = None, seed: int = 0):
        self.llm = llm
        self.template = template
        self.assistant_token = assistant_token
        self.seed = seed

    def chat(self, messages: List[Message], max_new_tokens: int = 1000,
             temperature: float = 0.2, repetition_penalty: float = 1.1) -> str:
        prompt = self.template(messages)
        reply = self.llm.generate_text(prompt, max_new_tokens=max_new_tokens,
                                       temperature=temperature,
                                       repetition_penalty=repetition_penalty,
                                       seed=self.seed)
        # parity with reference reply extraction: keep text after the last
        # assistant token if the model echoed the prompt (RAGHelper_local.py:266-271)
        if self.assistant_token and self.assistant_token in reply:
            reply = reply.rsplit(self.assistant_token, 1)[-1]
        for stop in ("<|eot_id|>", "<|end_of_text|>"):
            if stop in reply:
                reply = reply.split(stop, 1)[0]
        return reply.strip()


class StaticChatBackend(ChatBackend):
    """Deterministic scripted backend for tests/evals: matches the first
    rule whose keyword appears in the last message; else echoes a default."""

    def __init__(self, rules: Optional[Sequence[tuple]] = None,
                 default: str = "I could not find an answer."):
        self.rules = list(rules or [])
        self.default = default
        self.calls: List[List[Message]] = []

    def chat(self, messages: List[Message], **kw) -> str:
        self.calls.append(messages)
        text = messages[-1]["content"] if messages else ""
        all_text = "\n".join(m["content"] for m in messages)
        for keyword, response in self.rules:
            if keyword in text or keyword in all_text:
                return response
        return self.default


class CloudChatBackend(ChatBackend):
    """HTTP adapters for the reference's cloud LLM matrix
    (RAGHelper_cloud.py:60-88). Provider chosen by flags, credentials from
    env, requests made lazily so offline environments can still construct
    the pipeline object."""

    def __init__(self, provider: str, model_name: str,
                 api_key: Optional[str] = None, base_url: Optional[str] = None,
                 timeout: int = 120):
        if provider not in ("openai", "azure", "gemini", "ollama"):
            raise ValueError(f"unknown cloud provider: {provider}")
        self.provider = provider
        self.model_name = model_name
        self.api_key = api_key
        self.base_url = base_url
        self.timeout = timeout

    @classmethod
    def from_config(cls, model_cfg) -> "CloudChatBackend":
        if model_cfg.use_openai:
            return cls("openai", model_cfg.openai_model_name,
                       api_key=os.getenv("OPENAI_API_KEY"))
        if model_cfg.use_gemini:
            return cls("gemini", model_cfg.gemini_model_name,
                       api_key=os.getenv("GOOGLE_API_KEY"))
        if model_cfg.use_azure:
            return cls("azure", model_cfg.openai_model_name,
                       api_key=os.getenv("AZURE_OPENAI_API_KEY"),
                       base_url=os.getenv("AZURE_OPENAI_ENDPOINT"))
        if model_cfg.use_ollama:
            return cls("ollama", model_cfg.ollama_model,
                       base_url=os.getenv("OLLAMA_BASE_URL",
                                          "http://localhost:11434"))
        raise ValueError("no cloud provider enabled in config")

    # transient statuses worth retrying (rate limit + upstream hiccups)
    _RETRY_STATUSES = (429, 500, 502, 503)
    _MAX_ATTEMPTS = 3

    def _post_json(self, url: str, body: dict, headers: Optional[dict] = None):
        """POST with bounded retry on transient statuses, honoring
        Retry-After, on ``urllib.request`` (the port uses no ``requests``).
        Raises urllib.error.HTTPError (the provider's error body readable
        from it) on a non-retryable or exhausted failure."""
        import time
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode()
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        for attempt in range(self._MAX_ATTEMPTS):
            req = urllib.request.Request(url, data=data, headers=hdrs, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code not in self._RETRY_STATUSES or \
                        attempt == self._MAX_ATTEMPTS - 1:
                    raise
                delay = e.headers.get("Retry-After")
            time.sleep(min(float(delay) if delay else 0.5 * 2 ** attempt, 30))

    def chat(self, messages: List[Message], max_new_tokens: int = 1000,
             temperature: float = 0.2, repetition_penalty: float = 1.1) -> str:
        if self.provider == "openai":
            url = (self.base_url or "https://api.openai.com/v1") + "/chat/completions"
            headers = {"Authorization": f"Bearer {self.api_key}",
                       "Content-Type": "application/json"}
            body = {"model": self.model_name, "messages": messages,
                    "max_tokens": max_new_tokens, "temperature": temperature}
            out = self._post_json(url, body, headers)
            return out["choices"][0]["message"]["content"]
        if self.provider == "azure":
            # Azure OpenAI wire format (what the reference's AzureChatOpenAI
            # speaks, RAGHelper_cloud.py:77-83): api-key header — NOT
            # Bearer — and the deployments URL with an api-version query.
            api_version = os.getenv("AZURE_OPENAI_API_VERSION", "2024-02-01")
            url = (f"{(self.base_url or '').rstrip('/')}/openai/deployments/"
                   f"{self.model_name}/chat/completions"
                   f"?api-version={api_version}")
            headers = {"api-key": self.api_key or "",
                       "Content-Type": "application/json"}
            body = {"messages": messages, "max_tokens": max_new_tokens,
                    "temperature": temperature}
            out = self._post_json(url, body, headers)
            return out["choices"][0]["message"]["content"]
        if self.provider == "gemini":
            base = (self.base_url
                    or "https://generativelanguage.googleapis.com")
            url = (f"{base.rstrip('/')}/v1beta/models/"
                   f"{self.model_name}:generateContent")
            # role mapping per the generateContent contract: only
            # user/model are valid in `contents`; system prompts ride
            # `systemInstruction` (LangChain's convert_system_message)
            contents = []
            system_parts = []
            for m in messages:
                if m["role"] == "system":
                    system_parts.append({"text": m["content"]})
                else:
                    contents.append(
                        {"role": "model" if m["role"] == "assistant"
                         else "user",
                         "parts": [{"text": m["content"]}]})
            body = {"contents": contents,
                    "generationConfig": {
                        "maxOutputTokens": max_new_tokens,
                        "temperature": temperature}}
            if system_parts:
                body["systemInstruction"] = {"parts": system_parts}
            out = self._post_json(url, body,
                                  {"x-goog-api-key": self.api_key or "",
                                   "Content-Type": "application/json"})
            return out["candidates"][0]["content"]["parts"][0]["text"]
        # ollama
        url = (self.base_url or "http://localhost:11434") + "/api/chat"
        out = self._post_json(url, {
            "model": self.model_name, "messages": messages, "stream": False,
            "options": {"temperature": temperature,
                        "num_predict": max_new_tokens,
                        "repeat_penalty": repetition_penalty}})
        return out["message"]["content"]
