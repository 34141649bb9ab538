"""OpenAI-style HTTP/SSE streaming endpoint (§D13).

A zero-dependency asyncio HTTP/1.1 server in front of
:class:`AsyncServeLoop`: requests POSTed to ``/v1/completions`` (or the
``/v1/chat/completions`` alias) enter the front door's lifecycle at the
moment they arrive, stream tokens back as server-sent events
(``data: {json}\\n\\n`` chunks, ``data: [DONE]`` terminator — the OpenAI
wire shape), and a dropped connection aborts the request through the
same path a client cancel takes (KV released, decode row retired).
``GET /metrics`` serves the live rolling per-tier report; ``/healthz``
answers as long as the serve loop is alive.

stdlib-only on purpose: the repo's serving stack must boot anywhere the
test suite runs (no fastapi/uvicorn in the image), and the paper's
claims concern the scheduler behind the socket, not the socket itself.

Request body fields (all optional but ``prompt``/``messages``):
  ``prompt`` | ``messages``  text (chat messages are concatenated)
  ``prompt_tokens``          explicit prompt length (else ~chars/4)
  ``max_tokens``             output budget         (default 64)
  ``tier``                   SLO class name        (default standard)
  ``stream``                 SSE streaming         (default false)

Tokens are rendered through a tiny deterministic vocabulary (the sim
backends model cost, not content; the real engine's ids map through the
same table) so a streamed completion is reproducible byte-for-byte —
which is what the token-identity tests assert end-to-end over a real
socket.
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

from repro_torch.core.task_pool import Request
from repro_torch.serving.asyncloop import AsyncServeLoop, TokenStream

# deterministic id -> text rendering (no tokenizer in the image): a
# small word list cycled by token id, so streams are stable across runs
_WORDS = ("the of and to in is it as for on with that this by from at "
          "or an be are was were not have has had will would could can "
          "may might do does did so if then else when where how why "
          "what which who whom all any some none more most less few "
          "one two three four five six seven eight nine ten up down "
          "left right over under near far fast slow big small new old "
          "good bad high low long short first last next prev same "
          "other early late hot cold open close read write run stop "
          "go come make take give get put set let say see hear know "
          "think find keep turn start end begin finish work play live "
          "move stay bring hold carry send call ask tell show help "
          "try use need want like love time day night week month year "
          "hand eye head face side part place case point group fact "
          "world life house water fire earth air light dark sound "
          "word line page book name home road city state country").split()


def detok(tok: int) -> str:
    return _WORDS[tok % len(_WORDS)] + " "


class ServeHTTP:
    """Asyncio socket front end over one :class:`AsyncServeLoop`."""

    def __init__(self, loop: AsyncServeLoop, *,
                 default_max_tokens: int = 64):
        self.loop = loop
        self.default_max_tokens = default_max_tokens
        self._server: Optional[asyncio.AbstractServer] = None
        self._n = 0
        self.port: Optional[int] = None

    # -- lifecycle -----------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 8000):
        await self.loop.start()
        self._server = await asyncio.start_server(self._handle, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.loop.stop()

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- HTTP plumbing -------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req_line = await reader.readline()
            if not req_line:
                return
            try:
                method, path, _ = req_line.decode("latin1").split()
            except ValueError:
                return await self._plain(writer, 400, "bad request line")
            headers: Dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or 0)
            if n:
                body = await reader.readexactly(n)
            await self._route(method, path, body, reader, writer)
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     reader, writer) -> None:
        if method == "GET" and path == "/healthz":
            return await self._plain(writer, 200, "ok")
        if method == "GET" and path == "/metrics":
            return await self._json(writer, 200, self.loop.metrics())
        if method == "POST" and path in ("/v1/completions",
                                         "/v1/chat/completions"):
            try:
                payload = json.loads(body.decode() or "{}")
            except (ValueError, UnicodeDecodeError):
                return await self._json(writer, 400,
                                        {"error": "invalid JSON body"})
            return await self._completion(
                payload, chat=path.endswith("chat/completions"),
                reader=reader, writer=writer)
        await self._plain(writer, 404, "not found")

    @staticmethod
    def _head(status: int, ctype: str,
              extra: Tuple[str, ...] = ()) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  503: "Service Unavailable"}.get(status, "OK")
        lines = [f"HTTP/1.1 {status} {reason}",
                 f"Content-Type: {ctype}", "Connection: close"] \
            + list(extra)
        return ("\r\n".join(lines) + "\r\n\r\n").encode()

    async def _plain(self, writer, status: int, text: str) -> None:
        body = (text + "\n").encode()
        writer.write(self._head(
            status, "text/plain",
            (f"Content-Length: {len(body)}",)) + body)
        await writer.drain()

    async def _json(self, writer, status: int, obj: Dict) -> None:
        body = (json.dumps(obj, sort_keys=True, default=str)
                + "\n").encode()
        writer.write(self._head(
            status, "application/json",
            (f"Content-Length: {len(body)}",)) + body)
        await writer.drain()

    # -- the endpoint --------------------------------------------------
    def _build_request(self, payload: Dict, chat: bool) -> Request:
        if chat:
            text = " ".join(str(m.get("content", ""))
                            for m in payload.get("messages", []))
        else:
            text = str(payload.get("prompt", ""))
        prompt_tokens = int(payload.get("prompt_tokens", 0)) \
            or max(len(text) // 4, 1)
        self._n += 1
        return Request(
            req_id=f"cmpl-{self._n}",
            arrival=0.0,   # clamped to the serve clock by submit()
            prompt_len=prompt_tokens,
            output_len=int(payload.get("max_tokens",
                                       self.default_max_tokens)),
            tier=str(payload.get("tier", "standard")),
        )

    async def _completion(self, payload: Dict, chat: bool,
                          reader, writer) -> None:
        req = self._build_request(payload, chat)
        stream = bool(payload.get("stream", False))
        st = self.loop.submit(req)
        if st.closed and st.final_state != "done":
            # refused at the door (shed / rejected / kv_never_fits)
            status = 429 if st.reason in ("queue_full", None) else 400
            return await self._json(writer, status, {
                "error": {"type": st.final_state,
                          "reason": st.reason,
                          "request_id": req.req_id}})
        if stream:
            return await self._stream_sse(req, st, chat, reader, writer)
        toks = await st.collect()
        await self._json(writer, 200, self._final_body(
            req, st, toks, chat))

    def _final_body(self, req: Request, st: TokenStream, toks, chat):
        text = "".join(detok(t) for t in toks)
        finish = "stop" if st.final_state == "done" else st.final_state
        choice = {"index": 0, "finish_reason": finish}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        return {
            "id": req.req_id,
            "object": "chat.completion" if chat else "text_completion",
            "model": "flying-serving",
            "choices": [choice],
            "usage": {"prompt_tokens": req.prompt_len,
                      "completion_tokens": len(toks),
                      "total_tokens": req.prompt_len + len(toks)},
            "tier": req.tier,
        }

    async def _stream_sse(self, req: Request, st: TokenStream,
                          chat: bool, reader, writer) -> None:
        writer.write(self._head(200, "text/event-stream",
                                ("Cache-Control: no-cache",)))
        await writer.drain()
        # disconnect watcher: an EOF on the read side mid-stream means
        # the client went away — abort the request so its KV frees NOW,
        # not when the next token write trips on the dead socket
        eof_task = asyncio.ensure_future(reader.read(1))
        obj = "chat.completion.chunk" if chat else "text_completion"
        try:
            async for ev in st:
                if eof_task.done():
                    self.loop.abort(req.req_id)
                    break
                _, idx, tok, _t = ev
                delta = {"index": 0, "finish_reason": None}
                if chat:
                    delta["delta"] = {"content": detok(tok)}
                else:
                    delta["text"] = detok(tok)
                chunk = {"id": req.req_id, "object": obj,
                         "choices": [delta], "token": tok,
                         "token_index": idx}
                writer.write(b"data: "
                             + json.dumps(chunk).encode() + b"\n\n")
                await writer.drain()
            else:
                finish = "stop" if st.final_state == "done" \
                    else st.final_state
                tail = {"id": req.req_id, "object": obj,
                        "choices": [{"index": 0,
                                     "finish_reason": finish}],
                        "tier": req.tier}
                writer.write(b"data: " + json.dumps(tail).encode()
                             + b"\n\ndata: [DONE]\n\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            self.loop.abort(req.req_id)
        finally:
            eof_task.cancel()
