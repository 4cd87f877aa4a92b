"""Native browser UI for the HTTP TTS server — zero dependencies.

Role of the reference's gradio WebUI (reference `webui.py:94-269`: Voice
Clone tab with upload/mic prompt + Voice Creation tab with gender and 1-5
pitch/speed sliders), rebuilt as a single self-contained HTML page served by
`serve/server.py` at GET `/` (a copy of the JAX package's page).  gradio is
optional, and a serving stack should not need it: the page talks to the
same `/tts` and `/tts_stream` endpoints every other client uses, so the UI
exercises the production path instead of a parallel gradio one.

Everything runs client-side in vanilla JS:

  * prompt audio from file upload OR microphone (MediaRecorder), decoded and
    resampled to the pipeline rate with OfflineAudioContext — the server
    contract stays raw little-endian float32 PCM, base64 (`prompt_wav_b64`);
  * offline synthesis plays the returned waveform via a WAV blob;
  * streaming synthesis consumes the NDJSON chunk stream progressively and
    schedules each chunk gapless on an AudioContext clock, surfacing
    first-chunk latency (the reference UI has no streaming mode at all).
"""

from __future__ import annotations

from string import Template

from sparktts_tpu_torch.utils.tokens import LEVELS_MAP_UI

_PAGE = Template("""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Spark-TTS (CUDA)</title>
<style>
  :root {
    --bg: #14161a; --panel: #1d2026; --edge: #2c313a; --text: #e6e8eb;
    --dim: #9aa3af; --accent: #4f8cc9; --accent2: #3c6e9f; --err: #d86a6a;
  }
  * { box-sizing: border-box; }
  body { margin: 0; background: var(--bg); color: var(--text);
         font: 15px/1.5 system-ui, sans-serif; }
  .wrap { max-width: 760px; margin: 0 auto; padding: 24px 16px 48px; }
  h1 { font-size: 22px; font-weight: 600; margin: 0 0 2px; }
  .sub { color: var(--dim); font-size: 13px; margin-bottom: 20px; }
  .tabs { display: flex; gap: 8px; margin-bottom: 16px; }
  .tabs button { flex: 1; padding: 10px; background: var(--panel);
    color: var(--dim); border: 1px solid var(--edge); border-radius: 8px;
    font-size: 15px; cursor: pointer; }
  .tabs button.active { color: var(--text); border-color: var(--accent);
    background: #20262e; }
  .panel { background: var(--panel); border: 1px solid var(--edge);
    border-radius: 10px; padding: 18px; display: none; }
  .panel.active { display: block; }
  label { display: block; font-size: 13px; color: var(--dim); margin: 12px 0 4px; }
  textarea, input[type=text] { width: 100%; background: #14171c;
    color: var(--text); border: 1px solid var(--edge); border-radius: 6px;
    padding: 8px 10px; font: inherit; resize: vertical; }
  textarea { min-height: 64px; }
  .row { display: flex; gap: 12px; align-items: center; flex-wrap: wrap; }
  .btn { padding: 8px 16px; background: var(--accent); color: #fff;
    border: 0; border-radius: 6px; font: inherit; cursor: pointer; }
  .btn:hover { background: var(--accent2); }
  .btn.minor { background: #2a2f37; color: var(--text);
    border: 1px solid var(--edge); }
  .btn:disabled { opacity: .45; cursor: default; }
  .btn.rec-live { background: var(--err); }
  input[type=range] { flex: 1; accent-color: var(--accent); }
  .slider-val { min-width: 86px; color: var(--dim); font-size: 13px;
    text-align: right; }
  .status { margin-top: 14px; font-size: 13px; color: var(--dim);
    min-height: 20px; white-space: pre-wrap; }
  .status.err { color: var(--err); }
  audio { width: 100%; margin-top: 10px; }
  .prompt-state { font-size: 13px; color: var(--dim); }
  .radio-row label { display: inline; margin-right: 14px; color: var(--text);
    font-size: 14px; }
  footer { margin-top: 22px; font-size: 12px; color: var(--dim); }
  footer a { color: var(--accent); text-decoration: none; }
</style>
</head>
<body>
<div class="wrap">
  <h1>Spark-TTS</h1>
  <div class="sub">Text-to-speech on the GPU &mdash; voice cloning and controllable creation</div>

  <div class="tabs">
    <button id="tab-clone" class="active" onclick="showTab('clone')">Voice Clone</button>
    <button id="tab-create" onclick="showTab('create')">Voice Creation</button>
  </div>

  <div id="panel-clone" class="panel active">
    <label for="clone-text">Text to synthesize</label>
    <textarea id="clone-text" placeholder="Type what the cloned voice should say&hellip;"></textarea>
    <label for="clone-prompt-text">Prompt transcript (optional &mdash; text spoken in the prompt audio)</label>
    <input type="text" id="clone-prompt-text">
    <label>Prompt audio</label>
    <div class="row">
      <input type="file" id="clone-file" accept="audio/*">
      <button class="btn minor" id="rec-btn" onclick="toggleRecord()">&#9679; Record</button>
      <span class="prompt-state" id="prompt-state">no prompt loaded</span>
    </div>
    <audio id="prompt-audio" controls style="display:none"></audio>
    <div class="row" style="margin-top:10px">
      <label><input type="checkbox" id="clone-longform"> longform
        (sentence-segmented, for texts beyond the generation budget)</label>
    </div>
    <div class="row" style="margin-top:16px">
      <button class="btn" id="clone-go" onclick="synthesize('clone', false)">Generate</button>
      <button class="btn minor" id="clone-stream" onclick="synthesize('clone', true)">Stream</button>
    </div>
    <div class="status" id="clone-status"></div>
    <audio id="clone-out" controls style="display:none"></audio>
  </div>

  <div id="panel-create" class="panel">
    <label for="create-text">Text to synthesize</label>
    <textarea id="create-text" placeholder="Type what the created voice should say&hellip;"></textarea>
    <label>Gender</label>
    <div class="row radio-row">
      <label><input type="radio" name="gender" value="female" checked> female</label>
      <label><input type="radio" name="gender" value="male"> male</label>
    </div>
    <label for="pitch">Pitch</label>
    <div class="row">
      <input type="range" id="pitch" min="1" max="5" value="3" step="1"
             oninput="sliderLabel('pitch')">
      <span class="slider-val" id="pitch-val">moderate</span>
    </div>
    <label for="speed">Speed</label>
    <div class="row">
      <input type="range" id="speed" min="1" max="5" value="3" step="1"
             oninput="sliderLabel('speed')">
      <span class="slider-val" id="speed-val">moderate</span>
    </div>
    <div class="row" style="margin-top:10px">
      <label><input type="checkbox" id="create-longform"> longform
        (sentence-segmented, for texts beyond the generation budget)</label>
    </div>
    <div class="row" style="margin-top:16px">
      <button class="btn" id="create-go" onclick="synthesize('create', false)">Generate</button>
      <button class="btn minor" id="create-stream" onclick="synthesize('create', true)">Stream</button>
    </div>
    <div class="status" id="create-status"></div>
    <audio id="create-out" controls style="display:none"></audio>
  </div>

  <footer>server sample rate $sample_rate Hz &middot; <a href="/stats">/stats</a> &middot; <a href="/health">/health</a></footer>
</div>

<script>
"use strict";
const SR = $sample_rate;
const LEVELS = $levels_json;
const state = { prompt: null, recorder: null, recChunks: [] };

function showTab(name) {
  for (const t of ["clone", "create"]) {
    document.getElementById("tab-" + t).classList.toggle("active", t === name);
    document.getElementById("panel-" + t).classList.toggle("active", t === name);
  }
}

function sliderLabel(id) {
  document.getElementById(id + "-val").textContent =
    LEVELS[document.getElementById(id).value];
}

function setStatus(tab, msg, isErr) {
  const el = document.getElementById(tab + "-status");
  el.textContent = msg;
  el.className = "status" + (isErr ? " err" : "");
}

// ---- audio helpers ------------------------------------------------------

function f32ToB64(f32) {
  const bytes = new Uint8Array(f32.buffer, f32.byteOffset, f32.byteLength);
  let bin = "";
  for (let i = 0; i < bytes.length; i += 0x8000)
    bin += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
  return btoa(bin);
}

function b64ToF32(b64) {
  const bin = atob(b64);
  const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return new Float32Array(bytes.buffer);
}

function f32ToWavBlob(f32, sr) {
  // 16-bit PCM WAV for the <audio> element
  const n = f32.length, buf = new ArrayBuffer(44 + n * 2), v = new DataView(buf);
  const ws = (o, s) => { for (let i = 0; i < s.length; i++) v.setUint8(o + i, s.charCodeAt(i)); };
  ws(0, "RIFF"); v.setUint32(4, 36 + n * 2, true); ws(8, "WAVE");
  ws(12, "fmt "); v.setUint32(16, 16, true); v.setUint16(20, 1, true);
  v.setUint16(22, 1, true); v.setUint32(24, sr, true);
  v.setUint32(28, sr * 2, true); v.setUint16(32, 2, true); v.setUint16(34, 16, true);
  ws(36, "data"); v.setUint32(40, n * 2, true);
  for (let i = 0; i < n; i++) {
    const s = Math.max(-1, Math.min(1, f32[i]));
    v.setInt16(44 + i * 2, s < 0 ? s * 0x8000 : s * 0x7fff, true);
  }
  return new Blob([buf], { type: "audio/wav" });
}

async function decodeToPrompt(arrayBuf, label) {
  // decode any container the browser understands, downmix + resample to SR
  const probe = new AudioContext();
  const decoded = await probe.decodeAudioData(arrayBuf);
  probe.close();
  const frames = Math.max(1, Math.round(decoded.duration * SR));
  const off = new OfflineAudioContext(1, frames, SR);
  const src = off.createBufferSource();
  src.buffer = decoded;
  src.connect(off.destination);
  src.start();
  const mono = await off.startRendering();
  setPrompt(mono.getChannelData(0).slice(), label);
}

function setPrompt(f32, label) {
  state.prompt = f32;
  document.getElementById("prompt-state").textContent =
    label + " (" + (f32.length / SR).toFixed(1) + " s)";
  const a = document.getElementById("prompt-audio");
  a.src = URL.createObjectURL(f32ToWavBlob(f32, SR));
  a.style.display = "block";
}

document.getElementById("clone-file").addEventListener("change", async (e) => {
  const f = e.target.files[0];
  if (!f) return;
  try { await decodeToPrompt(await f.arrayBuffer(), f.name); }
  catch (err) { setStatus("clone", "could not decode audio: " + err, true); }
});

async function toggleRecord() {
  const btn = document.getElementById("rec-btn");
  if (state.recorder) {
    state.recorder.stop();
    return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({ audio: true });
    const rec = new MediaRecorder(stream);
    state.recorder = rec;
    state.recChunks = [];
    rec.ondataavailable = (e) => state.recChunks.push(e.data);
    rec.onstop = async () => {
      stream.getTracks().forEach((t) => t.stop());
      state.recorder = null;
      btn.classList.remove("rec-live");
      btn.innerHTML = "&#9679; Record";
      const blob = new Blob(state.recChunks);
      try { await decodeToPrompt(await blob.arrayBuffer(), "microphone"); }
      catch (err) { setStatus("clone", "could not decode recording: " + err, true); }
    };
    rec.start();
    btn.classList.add("rec-live");
    btn.innerHTML = "&#9632; Stop";
  } catch (err) {
    setStatus("clone", "microphone unavailable: " + err, true);
  }
}

// ---- synthesis ----------------------------------------------------------

function buildPayload(tab) {
  if (tab === "clone") {
    const text = document.getElementById("clone-text").value.trim();
    if (!text) throw new Error("enter text to synthesize");
    if (!state.prompt) throw new Error("load or record prompt audio first");
    const p = { text, prompt_wav_b64: f32ToB64(state.prompt) };
    const pt = document.getElementById("clone-prompt-text").value.trim();
    if (pt.length >= 2) p.prompt_text = pt;
    if (document.getElementById("clone-longform").checked) p.longform = true;
    return p;
  }
  const text = document.getElementById("create-text").value.trim();
  if (!text) throw new Error("enter text to synthesize");
  const p = {
    text,
    gender: document.querySelector("input[name=gender]:checked").value,
    pitch: LEVELS[document.getElementById("pitch").value],
    speed: LEVELS[document.getElementById("speed").value],
  };
  if (document.getElementById("create-longform").checked) p.longform = true;
  return p;
}

function setBusy(tab, busy) {
  for (const id of [tab + "-go", tab + "-stream"])
    document.getElementById(id).disabled = busy;
}

async function synthesize(tab, streaming) {
  let payload;
  try { payload = buildPayload(tab); }
  catch (err) { setStatus(tab, String(err.message || err), true); return; }
  setBusy(tab, true);
  const out = document.getElementById(tab + "-out");
  out.style.display = "none";
  try {
    if (streaming) await runStream(tab, payload, out);
    else await runOffline(tab, payload, out);
  } catch (err) {
    setStatus(tab, "request failed: " + (err.message || err), true);
  } finally {
    setBusy(tab, false);
  }
}

async function runOffline(tab, payload, out) {
  setStatus(tab, "synthesizing…");
  const t0 = performance.now();
  const resp = await fetch("/tts", { method: "POST", body: JSON.stringify(payload) });
  const body = await resp.json();
  if (!resp.ok || body.error) throw new Error(body.error || resp.status);
  const wav = b64ToF32(body.wav_b64);
  out.src = URL.createObjectURL(f32ToWavBlob(wav, body.sample_rate));
  out.style.display = "block";
  out.play().catch(() => {});
  setStatus(tab, (wav.length / body.sample_rate).toFixed(2) + " s of audio in " +
    ((performance.now() - t0) / 1000).toFixed(2) + " s (server infer " +
    (body.infer_ms / 1000).toFixed(2) + " s)");
}

async function runStream(tab, payload, out) {
  setStatus(tab, "streaming…");
  const t0 = performance.now();
  const resp = await fetch("/tts_stream", { method: "POST", body: JSON.stringify(payload) });
  if (!resp.ok) {
    let msg = resp.status;
    try { msg = (await resp.json()).error || msg; } catch (e) {}
    throw new Error(msg);
  }
  const ctx = new AudioContext({ sampleRate: SR });
  let nextT = 0, firstMs = null, nChunks = 0;
  const pieces = [];
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = "";
  for (;;) {
    const { done, value } = await reader.read();
    if (done) break;
    buf += dec.decode(value, { stream: true });
    const lines = buf.split("\\n");
    buf = lines.pop();
    for (const line of lines) {
      if (!line.trim()) continue;
      const msg = JSON.parse(line);
      if (msg.error) { ctx.close(); throw new Error(msg.error); }
      if (msg.done) continue;
      const f32 = b64ToF32(msg.wav_b64);
      pieces.push(f32);
      nChunks++;
      if (firstMs === null) firstMs = performance.now() - t0;
      // schedule gapless on the context clock
      const ab = ctx.createBuffer(1, f32.length, msg.sample_rate);
      ab.getChannelData(0).set(f32);
      const src = ctx.createBufferSource();
      src.buffer = ab;
      src.connect(ctx.destination);
      nextT = Math.max(nextT, ctx.currentTime + 0.03);
      src.start(nextT);
      nextT += ab.duration;
      setStatus(tab, "first chunk " + firstMs.toFixed(0) + " ms · " +
        nChunks + " chunks…");
    }
  }
  const total = pieces.reduce((s, p) => s + p.length, 0);
  const all = new Float32Array(total);
  let o = 0;
  for (const p of pieces) { all.set(p, o); o += p.length; }
  out.src = URL.createObjectURL(f32ToWavBlob(all, SR));
  out.style.display = "block";
  const wait = Math.max(0, (nextT - ctx.currentTime) * 1000) + 100;
  setTimeout(() => ctx.close().catch(() => {}), wait);
  setStatus(tab, (total / SR).toFixed(2) + " s of audio · first chunk " +
    (firstMs === null ? "—" : firstMs.toFixed(0) + " ms") + " · " +
    nChunks + " chunks · total " +
    ((performance.now() - t0) / 1000).toFixed(2) + " s");
}

sliderLabel("pitch");
sliderLabel("speed");
</script>
</body>
</html>
""")


def render_ui(sample_rate: int) -> str:
    """The UI page with the server's sample rate and the reference's 1-5
    slider-level mapping (reference `webui.py:38-45` LEVELS_MAP_UI) baked in."""
    import json

    levels = {str(k): v for k, v in LEVELS_MAP_UI.items()}
    return _PAGE.substitute(
        sample_rate=int(sample_rate), levels_json=json.dumps(levels)
    )
