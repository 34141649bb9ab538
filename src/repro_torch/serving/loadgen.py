"""Load-generation harness for the async serving core (§D13).

Turns a :mod:`repro_torch.serving.workload` trace — Poisson or bursty
Markov-modulated arrivals, heavy-tail lognormal lengths, tier mixes,
scripted client cancels — into *live* traffic against the serving
stack, two ways:

* ``drive_inprocess(loop, reqs)`` — submits every request to an
  :class:`AsyncServeLoop` and consumes all token streams concurrently
  (thousands of them: one lightweight task per stream). Under
  ``pace="virtual"`` this replays the trace exactly like the offline
  ``FrontDoor.run`` path — same virtual timestamps, same admission
  decisions — which is what makes the §D13 saturation comparison
  apples-to-apples; under ``pace="wall"`` it behaves like a real client
  fleet.

* ``drive_http(host, port, reqs)`` — the same trace over real sockets
  against :class:`repro_torch.serving.server.ServeHTTP`: POSTs each request
  at its (scaled) wall-clock arrival, parses the SSE stream, and turns
  scripted ``cancel_at`` timestamps into client DISCONNECTS mid-stream
  (the socket just closes — exercising the server's EOF-watcher abort
  path rather than the front door's scripted sweep).

Both return per-request records (tier, final state, token count, TTFT /
TPOT where observable) ready for ``metrics.tier_report``-style
aggregation in ``benchmarks/server_bench.py``.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.task_pool import Request
from repro_torch.serving.asyncloop import AsyncServeLoop, TokenStream


# ---------------------------------------------------------------------------
# in-process driver
# ---------------------------------------------------------------------------

async def _consume(st: TokenStream, rec: Dict,
                   collect_tokens: bool) -> None:
    toks: List[int] = []
    n = 0
    first_t = last_t = None
    async for ev in st:
        _, _idx, tok, t = ev
        n += 1
        if first_t is None:
            first_t = t
        last_t = t
        if collect_tokens:
            toks.append(tok)
    rec["state"] = st.final_state
    rec["reason"] = st.reason
    rec["overflowed"] = st.overflowed
    rec["n_tokens"] = n
    rec["first_token_t"] = first_t
    rec["last_token_t"] = last_t
    if collect_tokens:
        rec["tokens"] = toks


async def drive_inprocess(loop: AsyncServeLoop, reqs: Sequence[Request],
                          *, collect_tokens: bool = False,
                          start: bool = True) -> Dict:
    """Submit a whole trace and consume every stream concurrently.
    Returns ``{"wall_s", "records", "loop"}``; virtual-time latency
    metrics live on the Request objects themselves (the front door
    stamps them exactly as the offline path does)."""
    if start:
        await loop.start()
    t0 = time.perf_counter()
    records: List[Dict] = []
    tasks = []
    for r in reqs:
        rec = {"req_id": r.req_id, "tier": r.tier, "arrival": r.arrival}
        records.append(rec)
        st = loop.submit(r)
        tasks.append(asyncio.ensure_future(
            _consume(st, rec, collect_tokens)))
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t0
    if start:
        await loop.stop()
    return {"wall_s": wall, "records": records, "loop": loop}


# ---------------------------------------------------------------------------
# HTTP driver
# ---------------------------------------------------------------------------

async def _one_http(host: str, port: int, r: Request, t0: float,
                    scale: float, sem: Optional[asyncio.Semaphore],
                    collect_tokens: bool) -> Dict:
    rec: Dict = {"req_id": r.req_id, "tier": r.tier,
                 "arrival": r.arrival, "state": "error", "n_tokens": 0}
    aloop = asyncio.get_event_loop()
    delay = r.arrival * scale - (aloop.time() - t0)
    if delay > 0:
        await asyncio.sleep(delay)
    if sem is not None:
        await sem.acquire()
    try:
        reader, writer = await asyncio.open_connection(host, port)
        body = json.dumps({
            "prompt_tokens": r.prompt_len,
            "max_tokens": r.output_len,
            "tier": r.tier,
            "stream": True,
        }).encode()
        writer.write((
            "POST /v1/completions HTTP/1.1\r\nHost: lg\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        sent = aloop.time()
        # scripted cancel -> client disconnect this many wall seconds in
        hangup = sent + (r.cancel_at - r.arrival) * scale \
            if r.cancel_at is not None else None
        toks: List[int] = []
        first = None
        while True:
            if hangup is not None and aloop.time() >= hangup:
                rec["state"] = "client_closed"
                break
            line = await reader.readline()
            if not line:
                rec["state"] = "dropped"
                break
            if not line.startswith(b"data: "):
                continue
            payload = line[6:].strip()
            if payload == b"[DONE]":
                break
            ev = json.loads(payload)
            if "token" in ev:
                if first is None:
                    first = aloop.time()
                rec["n_tokens"] += 1
                if collect_tokens:
                    toks.append(ev["token"])
            else:
                fin = ev["choices"][0].get("finish_reason")
                rec["state"] = "done" if fin == "stop" else (fin or "?")
        if first is not None:
            rec["ttft_wall_s"] = first - sent
        if collect_tokens:
            rec["tokens"] = toks
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
    except (ConnectionError, OSError) as e:
        rec["error"] = str(e)
    finally:
        if sem is not None:
            sem.release()
    return rec


async def drive_http(host: str, port: int, reqs: Sequence[Request], *,
                     time_scale: float = 1.0,
                     max_conns: int = 0,
                     collect_tokens: bool = False) -> Dict:
    """Replay a trace over real sockets: each request POSTs at its
    scaled wall-clock arrival (``time_scale`` < 1 compresses the
    trace), scripted cancels become mid-stream disconnects."""
    aloop = asyncio.get_event_loop()
    t0 = aloop.time() - min(r.arrival for r in reqs) * time_scale \
        if reqs else aloop.time()
    sem = asyncio.Semaphore(max_conns) if max_conns else None
    t_wall = time.perf_counter()
    records = await asyncio.gather(*(
        _one_http(host, port, r, t0, time_scale, sem, collect_tokens)
        for r in reqs))
    return {"wall_s": time.perf_counter() - t_wall,
            "records": list(records)}
