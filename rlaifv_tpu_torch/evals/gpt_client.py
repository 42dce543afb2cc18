# A copy of rlaifv_tpu/evals/gpt_client.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""GPT judge client: one HTTP client with retry/backoff, transport-injected.

Replaces the reference's two near-duplicate clients
(ref: eval/gpt4.py:14-69 and eval/gpt4_grpc.py:6-65 — openai 0.28 globals,
infinite retry with a fail limit returning a sentinel). Endpoint/key are
explicit parameters or env (OPENAI_BASE_URL / OPENAI_API_KEY) — the
reference hardcodes them (gpt4.py:11-12).

The transport is a callable (model, messages, **kw) -> (text, usage) so
tests and offline runs can stub the network.
"""
from __future__ import annotations

import json
import os
import time
import urllib.request
from typing import Callable, List, Optional, Tuple

FAIL_SENTINEL = "-1\n<no_response>"


def openai_http_transport(
    base_url: Optional[str] = None, api_key: Optional[str] = None,
    timeout: float = 100.0,
):
    base_url = base_url or os.environ.get(
        "OPENAI_BASE_URL", "https://api.openai.com/v1"
    )
    api_key = api_key or os.environ.get("OPENAI_API_KEY", "")

    def call(model: str, messages: List[dict], **kw) -> Tuple[str, dict]:
        body = json.dumps({"model": model, "messages": messages, **kw}).encode()
        req = urllib.request.Request(
            base_url.rstrip("/") + "/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {api_key}",
            },
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        text = out["choices"][0]["message"]["content"]
        return text, out.get("usage", {})

    return call


class Chat:
    """Retrying chat wrapper (ref gpt4.py:41-69 semantics: exponential-ish
    backoff, fail_limit attempts, sentinel on give-up)."""

    def __init__(
        self,
        model: str = "gpt-3.5-turbo-0613",
        transport: Optional[Callable] = None,
        timeout_sec: float = 100.0,
        backoff_base: float = 2.0,
        max_backoff: float = 30.0,
    ):
        self.model = model
        self.transport = transport or openai_http_transport(timeout=timeout_sec)
        self.backoff_base = backoff_base
        self.max_backoff = max_backoff

    def chat_completion(
        self, messages: List[dict], fail_limit: int = 100, **kw
    ) -> Tuple[str, dict]:
        """Returns (text, usage); (FAIL_SENTINEL, {}) after fail_limit errors."""
        for attempt in range(fail_limit):
            try:
                return self.transport(self.model, messages, **kw)
            except Exception as e:  # network/API errors: back off and retry
                wait = min(self.backoff_base * (attempt + 1), self.max_backoff)
                print(f"[gpt] attempt {attempt}: {type(e).__name__}: {e}; "
                      f"retry in {wait:.0f}s", flush=True)
                time.sleep(wait)
        return FAIL_SENTINEL, {}
