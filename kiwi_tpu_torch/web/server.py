"""Interactive web seismosizer (web/cgi-bin/seismograms.pl, 819 lines of
Perl CGI around a piped `minimizer` process; port of
kiwi_tpu/web/server.py on the port's engine).

Same interaction model, engine-resident internals: a form posts source
parameters + receiver coordinates; the server keeps per-session result
*generations* on disk (seismograms.pl:47-67's session/generation scheme),
runs the Engine forward for each calculate, renders seismogram comparison
PNGs of the current vs previous generation (:242-258), and serves the
images back (:69-80's getfile).  Implemented on the stdlib http.server --
no CGI, no subprocess pipes; the engine object is resident and reuses its
plans across requests.  The engine runs on the card unless the caller
asks for the CPU (`device="cpu"`, `--device cpu`); with no card a
`device="cuda"` app refuses to start.

Where matplotlib does not import (the GPU host has none), a calculate still
writes its generation's result.json, draws no figure, and the page says
that the figures were skipped and why; the trace browser serves as ever.
matplotlib is imported only to draw.  A failure of the card or of a kernel
(pipeline.is_card_failure) answers HTTP 500 and is logged with its
traceback; an input error (no receivers, a bad parameter) keeps the
reference's error page.

Run:  python -m kiwi_tpu_torch.web <database> [--port 8642] [--workdir DIR]
                                  [--source-type TYPE] [--device cuda|cpu]
"""

from __future__ import annotations

import html
import json
import logging
import os
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..pipeline import is_card_failure
from ..plotting import matplotlib_missing

LOG = logging.getLogger(__name__)

_SAFE_FILE = re.compile(r"^[a-z0-9_.-]+$")


class SeismogramApp:
    """Session state + engine around one GF database."""

    def __init__(self, store, workdir, source_type="bilateral", device="cuda"):
        import torch

        from ..engine import Engine

        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the web seismosizer "
                               "(device='cpu' / --device cpu runs it on the CPU)")
        self.store = store
        self.workdir = workdir
        self.default_source_type = source_type
        self.engine = Engine(store, device=device)
        self.lock = threading.Lock()
        os.makedirs(workdir, exist_ok=True)

    # -- session/generation result dirs (seismograms.pl:47-67, :301-327) -----

    def _gen_dir(self, session, generation, create=False):
        # create=False by default: GET handlers resolve paths through this,
        # and a directory-creating GET side effect let any client mint
        # empty generations that broke the session landing page
        d = os.path.join(self.workdir, f"session-{int(session)}",
                         f"gen-{int(generation)}")
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def generations(self, session):
        """Completed generations only (result.json present): partially
        written directories never surface as openable generations."""
        base = os.path.join(self.workdir, f"session-{int(session)}")
        if not os.path.isdir(base):
            return []
        gens = []
        for name in sorted(os.listdir(base)):
            m = re.match(r"gen-(\d+)$", name)
            if m and os.path.exists(os.path.join(base, name, "result.json")):
                gens.append(int(m.group(1)))
        return sorted(gens)

    # -- the forward (seismograms.pl:344-420's calculate) ---------------------

    def source_centroids(self, session, generation):
        """Discretized centroid table of a generation's source (feeds the
        /source3d viewer -- the 3-D rupture-geometry role of the reference's
        snufflek/kinherd_sourceview VTK viewers)."""
        from ..profiling import to_host
        from ..sources import get_source_model

        form = self._load(session, generation)["form"]
        stype = form.get("sourcetype", self.default_source_type)
        model = get_source_model(stype)
        params = np.array(
            [float(form.get(f"param.{name}", model.defaults[i]))
             for i, name in enumerate(model.names)],
            dtype=np.float32,
        )
        with self.lock:
            eng = self.engine
            eng.set_effective_dt(float(form.get("effective_dt", self.store.dt)))
            eng.set_source_params(stype, params)
            cb = eng.discretize(params[None, :]).tables
            # the tables may sit on the card: one copy to the host
            keys = ("active", "m", "north", "east", "depth", "time")
            tab = dict(zip(keys, to_host(*(cb[k][0] for k in keys))))
        act = tab["active"].astype(bool)
        mmag = np.abs(tab["m"].astype(np.float64)).sum(axis=-1)
        return {
            "sourcetype": stype,
            "north": tab["north"][act].tolist(),
            "east": tab["east"][act].tolist(),
            "depth": tab["depth"][act].tolist(),
            "time": tab["time"][act].tolist(),
            "weight": mmag[act].tolist(),
        }

    def calculate(self, session, form):
        from ..sources import get_source_model

        stype = form.get("sourcetype", self.default_source_type)
        model = get_source_model(stype)
        params = np.array(
            [float(form.get(f"param.{name}", model.defaults[i]))
             for i, name in enumerate(model.names)],
            dtype=np.float32,
        )
        recs = []
        from ..engine import Receiver

        for line in form.get("receivers", "").splitlines():
            w = line.split()
            if len(w) >= 2:
                comps = w[2] if len(w) > 2 else "ned"
                recs.append(Receiver(float(w[0]), float(w[1]), comps))
        if not recs:
            raise ValueError("no receivers given")

        with self.lock:
            eng = self.engine
            eng.set_receivers(recs)
            eng.set_source_location(
                float(form.get("source_latitude", 0.0)),
                float(form.get("source_longitude", 0.0)),
                float(form.get("reference_time", 0.0)),
            )
            eng.set_effective_dt(float(form.get("effective_dt", self.store.dt)))
            eng.set_local_interpolation(form.get("interpolation", "bilinear") == "bilinear")
            eng.set_source_params(stype, params)
            traces = eng.get_synthetic_seismograms()
            layout = eng._rc_layout()

            # generation allocation + result/plot writes stay under the lock:
            # two concurrent POSTs for one session on ThreadingHTTPServer must
            # not pick the same generation and clobber each other's result dir
            gens = self.generations(session)
            generation = (gens[-1] + 1) if gens else 1
            gdir = self._gen_dir(session, generation, create=True)
            rows = []
            for (values, itmin), (irec, comp) in zip(traces, layout):
                rows.append({
                    "receiver": irec + 1,
                    "component": comp,
                    "itmin": int(itmin),
                    "values": np.asarray(values).tolist(),
                })
            with open(os.path.join(gdir, "result.json"), "w") as f:
                json.dump({"form": dict(form), "dt": self.store.dt, "traces": rows}, f)
            missing = matplotlib_missing()
            if missing is None:
                self._plot(session, generation)
            else:
                LOG.info("session %s generation %s: figures skipped: %s",
                         session, generation, missing)
        return generation

    def _plot(self, session, generation):
        """Per-receiver comparison PNGs of this generation vs the previous
        (seismograms.pl:242-258)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cur = self._load(session, generation)
        prev = None
        if generation > 1 and os.path.isdir(
            os.path.join(self.workdir, f"session-{int(session)}", f"gen-{generation-1}")
        ):
            prev = self._load(session, generation - 1)
        gdir = self._gen_dir(session, generation)
        byrec = {}
        for row in cur["traces"]:
            byrec.setdefault(row["receiver"], []).append(row)
        for irec, rows in byrec.items():
            fig, axes = plt.subplots(len(rows), 1, figsize=(8, 1.6 * len(rows)),
                                     squeeze=False, sharex=True)
            for ax, row in zip(axes[:, 0], rows):
                t = (row["itmin"] + np.arange(len(row["values"]))) * cur["dt"]
                ax.plot(t, row["values"], "k-", lw=0.8,
                        label=f"gen {generation}")
                if prev is not None:
                    for prow in prev["traces"]:
                        if (prow["receiver"], prow["component"]) == (
                                row["receiver"], row["component"]):
                            tp = (prow["itmin"] + np.arange(len(prow["values"]))) * prev["dt"]
                            ax.plot(tp, prow["values"], "r-", lw=0.8, alpha=0.6,
                                    label=f"gen {generation-1}")
                ax.set_ylabel(row["component"])
            axes[0, 0].legend(loc="upper right", fontsize=7)
            axes[-1, 0].set_xlabel("time [s]")
            fig.tight_layout()
            fig.savefig(os.path.join(gdir, f"seismogram-{irec}.png"), dpi=80)
            plt.close(fig)

    def _load(self, session, generation):
        with open(os.path.join(self._gen_dir(session, generation), "result.json")) as f:
            return json.load(f)

    # -- html ------------------------------------------------------------------

    def form_html(self, session, form, images, generation):
        from ..sources import SOURCE_REGISTRY, get_source_model

        missing = None if images or not generation else matplotlib_missing()
        skipped = (f"<p>figures skipped: {html.escape(missing)}</p>\n" if missing else "")

        stype = form.get("sourcetype", self.default_source_type)
        model = get_source_model(stype)
        opts = "".join(
            f'<option value="{n}"{" selected" if n == stype else ""}>{n}</option>'
            for n in sorted(SOURCE_REGISTRY)
        )
        rows = []
        for i, name in enumerate(model.names):
            val = html.escape(str(form.get(f"param.{name}", model.defaults[i])))
            rows.append(
                f"<tr><td>{name} [{model.units[i]}]</td>"
                f'<td><input name="param.{name}" value="{val}"></td></tr>'
            )
        recs = html.escape(form.get("receivers", "40.0 30.0 ned"))
        interp = form.get("interpolation", "bilinear")
        imgs = "".join(
            f'<p><img src="/file?session={session}&generation={generation}'
            f'&name={name}" alt="{name}"></p>'
            for name in images
        )
        return f"""<!DOCTYPE html><html><head><title>kiwi-tpu seismograms</title></head>
<body><h1>kiwi-tpu web seismosizer</h1>
<form method="post" action="/">
<input type="hidden" name="session" value="{session}">
<p>source type: <select name="sourcetype">{opts}</select>
(change type, calculate once to load its parameters)</p>
<table>{''.join(rows)}</table>
<p>source latitude <input name="source_latitude" value="{html.escape(str(form.get('source_latitude', '40.0')))}">
longitude <input name="source_longitude" value="{html.escape(str(form.get('source_longitude', '30.0')))}"></p>
<p>effective dt <input name="effective_dt" value="{html.escape(str(form.get('effective_dt', self.store.dt)))}">
interpolation <select name="interpolation">
<option value="bilinear"{'' if interp == 'nearest' else ' selected'}>bilinear</option><option value="nearest"{' selected' if interp == 'nearest' else ''}>nearest</option>
</select></p>
<p>receivers (lat lon [components], one per line):<br>
<textarea name="receivers" rows="4" cols="50">{recs}</textarea></p>
<p><button name="calculate" value="1">calculate</button></p>
</form>
<p>generation: {generation or 'none yet'}
{f'&mdash; <a href="/traces?session={session}&generation={generation}">interactive trace browser</a>' if generation else ''}
</p>
{skipped}{imgs}
</body></html>"""


class _Handler(BaseHTTPRequestHandler):
    app: SeismogramApp = None

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code, body, ctype="text/html; charset=utf-8"):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _card_failure(self, exc):
        """A failure of the card or of a kernel: logged, answered 500 (not
        a form error: the request was fine)."""
        LOG.error("card failure serving %s", self.path, exc_info=exc)
        return self._send(500, "<html><body><h1>card failure</h1>"
                               f"<pre>{html.escape(str(exc))}</pre></body></html>")

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(url.query))
        if url.path == "/file":
            # seismograms.pl:69-80: strictly validated file fetch
            name = q.get("name", "")
            if not _SAFE_FILE.match(name) or ".." in name:
                return self._send(400, "malformed parameter")
            try:
                gdir = self.app._gen_dir(int(q.get("session", 0)),
                                         int(q.get("generation", 0)))
            except ValueError:
                return self._send(400, "malformed parameter")
            path = os.path.join(gdir, name)
            if not os.path.isfile(path):
                return self._send(404, "no such file")
            with open(path, "rb") as f:
                ctype = "image/png" if name.endswith(".png") else "application/json"
                return self._send(200, f.read(), ctype)
        if url.path == "/traces":
            # interactive trace browser (the snufflek/kinherd viewer role):
            # client-side canvas rendering of a generation's result.json
            # with wheel zoom / drag pan / per-receiver gain
            try:
                session = int(q.get("session", 0))
                generation = int(q.get("generation", 0))
            except ValueError:
                return self._send(400, "malformed parameter")
            gens = self.app.generations(session)
            if not generation and gens:
                generation = gens[-1]
            if generation not in gens:
                return self._send(404, "no such generation")
            return self._send(200, _TRACE_VIEWER_HTML % {
                "session": session, "generation": generation,
                "gens": ",".join(str(g) for g in gens)})
        if url.path == "/source3d.json":
            try:
                session = int(q.get("session", 0))
                generation = int(q.get("generation", 0))
            except ValueError:
                return self._send(400, "malformed parameter")
            gens = self.app.generations(session)
            if not generation and gens:
                generation = gens[-1]
            if generation not in gens:
                return self._send(404, "no such generation")
            try:
                data = self.app.source_centroids(session, generation)
            except Exception as e:  # noqa: BLE001 -- card failures answer 500
                if not is_card_failure(e):
                    raise
                return self._card_failure(e)
            return self._send(200, json.dumps(data), "application/json")
        if url.path == "/source3d":
            try:
                session = int(q.get("session", 0))
                generation = int(q.get("generation", 0))
            except ValueError:
                return self._send(400, "malformed parameter")
            gens = self.app.generations(session)
            if not generation and gens:
                generation = gens[-1]
            if generation not in gens:
                return self._send(404, "no such generation")
            return self._send(200, _SOURCE3D_HTML % {
                "session": session, "generation": generation})
        if url.path == "/":
            try:
                session = int(q.get("session", os.getpid() % 100000))
            except ValueError:
                return self._send(400, "malformed parameter")
            gens = self.app.generations(session)
            generation = gens[-1] if gens else 0
            form = {}
            images = []
            if generation:
                form = self.app._load(session, generation)["form"]
                images = sorted(
                    n for n in os.listdir(self.app._gen_dir(session, generation))
                    if n.endswith(".png")
                )
            return self._send(200, self.app.form_html(session, form, images, generation))
        return self._send(404, "not found")

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        form = dict(urllib.parse.parse_qsl(self.rfile.read(length).decode()))
        try:
            session = int(form.get("session", 0) or 0)
        except ValueError:
            return self._send(400, "malformed parameter")
        try:
            generation = self.app.calculate(session, form)
        except Exception as e:  # render the error like the CGI's error()
            if is_card_failure(e):
                return self._card_failure(e)
            return self._send(200, f"<html><body><h1>error</h1><pre>{html.escape(str(e))}</pre>"
                                   f'<p><a href="/?session={session}">back</a></p></body></html>')
        images = sorted(
            n for n in os.listdir(self.app._gen_dir(session, generation))
            if n.endswith(".png")
        )
        return self._send(200, self.app.form_html(session, form, images, generation))


def serve(store, workdir, port=8642, source_type="bilateral", device="cuda"):
    """The server object (bound to 127.0.0.1:port, 0 for a free port); run
    it with serve_forever(), e.g. in a thread."""
    app = SeismogramApp(store, workdir, source_type, device)
    handler = type("Handler", (_Handler,), {"app": app})
    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    return srv


def main(argv=None):
    import argparse

    from ..gf.store import GFStore

    p = argparse.ArgumentParser(prog="kiwi_tpu_torch.web")
    p.add_argument("database")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--workdir", default="./webwork")
    p.add_argument("--source-type", default="bilateral")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = p.parse_args(argv)
    if opts.database.endswith(".npz"):
        store = GFStore.load(opts.database)
    else:
        from ..io.gfdb_hdf5 import load_gfdb

        store = load_gfdb(opts.database)
    srv = serve(store, opts.workdir, opts.port, opts.source_type, opts.device)
    print(f"serving on http://127.0.0.1:{srv.server_address[1]}/")
    srv.serve_forever()


if __name__ == "__main__":
    main()


_TRACE_VIEWER_HTML = """<!DOCTYPE html><html><head>
<title>kiwi-tpu trace browser</title>
<style>
body { font-family: sans-serif; background: #181818; color: #ddd; margin: 0; }
#bar { padding: 6px 12px; background: #262626; }
canvas { display: block; width: 100%%; }
a { color: #8cf; }
</style></head>
<body>
<div id="bar">
 <b>kiwi-tpu traces</b> &mdash; session %(session)s, generation
 <select id="gen" onchange="loadGen()"></select>
 &nbsp; wheel: zoom time &middot; drag: pan &middot; +/-: gain
 &nbsp; <a href="/?session=%(session)s">back to form</a>
</div>
<canvas id="cv"></canvas>
<script>
const SESSION = %(session)s, GENS = [%(gens)s];
let GEN = %(generation)s, R = null, t0 = 0, t1 = 1, gain = 1;
const sel = document.getElementById('gen');
for (const g of GENS) {
  const o = document.createElement('option');
  o.value = g; o.textContent = 'gen ' + g; if (g === GEN) o.selected = true;
  sel.appendChild(o);
}
function loadGen() {
  GEN = parseInt(sel.value);
  fetch(`/file?session=${SESSION}&generation=${GEN}&name=result.json`)
    .then(r => r.json()).then(d => {
      R = d;
      let lo = 1e30, hi = -1e30;
      for (const tr of R.traces) {
        lo = Math.min(lo, tr.itmin * R.dt);
        hi = Math.max(hi, (tr.itmin + tr.values.length) * R.dt);
      }
      t0 = lo; t1 = hi; gain = 1; draw();
    });
}
function draw() {
  if (!R) return;
  const cv = document.getElementById('cv');
  const w = cv.width = window.innerWidth;
  const n = R.traces.length;
  const rowh = Math.max(60, Math.floor((window.innerHeight - 60) / n));
  cv.height = rowh * n;
  const ctx = cv.getContext('2d');
  ctx.fillStyle = '#181818'; ctx.fillRect(0, 0, w, cv.height);
  R.traces.forEach((tr, i) => {
    const y0 = i * rowh, mid = y0 + rowh / 2;
    let amax = 1e-30;
    for (const v of tr.values) amax = Math.max(amax, Math.abs(v));
    ctx.strokeStyle = '#333';
    ctx.beginPath(); ctx.moveTo(0, y0 + rowh); ctx.lineTo(w, y0 + rowh); ctx.stroke();
    ctx.fillStyle = '#9a9';
    ctx.fillText(`r${tr.receiver} ${tr.component}  max ${amax.toExponential(2)}`, 6, y0 + 14);
    ctx.strokeStyle = '#8ec';
    ctx.beginPath();
    for (let x = 0; x < w; x++) {
      const t = t0 + (t1 - t0) * x / w;
      const j = Math.round(t / R.dt) - tr.itmin;
      const v = (j >= 0 && j < tr.values.length) ? tr.values[j] : 0;
      const y = mid - gain * (v / amax) * (rowh * 0.42);
      x ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    }
    ctx.stroke();
  });
  ctx.fillStyle = '#888';
  ctx.fillText(`${t0.toFixed(2)} s`, 4, cv.height - 4);
  ctx.fillText(`${t1.toFixed(2)} s`, w - 70, cv.height - 4);
}
document.getElementById('cv').addEventListener('wheel', e => {
  e.preventDefault();
  const f = e.deltaY > 0 ? 1.25 : 0.8;
  const tc = t0 + (t1 - t0) * e.offsetX / e.target.width;
  t0 = tc - (tc - t0) * f; t1 = tc + (t1 - tc) * f; draw();
});
let dragx = null;
document.getElementById('cv').addEventListener('mousedown', e => dragx = e.clientX);
window.addEventListener('mouseup', () => dragx = null);
window.addEventListener('mousemove', e => {
  if (dragx === null) return;
  const dt = (t1 - t0) * (dragx - e.clientX) / window.innerWidth;
  t0 += dt; t1 += dt; dragx = e.clientX; draw();
});
window.addEventListener('keydown', e => {
  if (e.key === '+') { gain *= 1.5; draw(); }
  if (e.key === '-') { gain /= 1.5; draw(); }
});
window.addEventListener('resize', draw);
loadGen();
</script></body></html>"""


_SOURCE3D_HTML = """<!DOCTYPE html><html><head>
<title>kiwi-tpu source view</title>
<style>body{font-family:sans-serif;margin:0;background:#111;color:#ddd}
#hud{position:fixed;top:8px;left:10px;font-size:12px}
canvas{display:block}</style></head><body>
<div id="hud">session %(session)s gen %(generation)s &middot; drag to rotate,
wheel to zoom &middot; color = rupture onset time, size = cell moment</div>
<canvas id="cv"></canvas>
<script>
// Self-contained 3-D point-cloud viewer (no external libs -- zero-egress):
// orthographic projection with drag-rotate, replacing the rupture-geometry
// view of the reference's snufflek / kinherd_sourceview VTK apps.
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});
let rotX = -1.0, rotZ = 0.6, zoom = 1.0, pts = null, scale = 1, cx=0, cy=0, cz=0;
let tmin=0, tmax=1, wmax=1;
fetch('/source3d.json?session=%(session)s&generation=%(generation)s')
 .then(r=>r.json()).then(d=>{
  const n=d.north, e=d.east, z=d.depth, t=d.time, w=d.weight;
  cx=e.reduce((a,b)=>a+b,0)/e.length; cy=n.reduce((a,b)=>a+b,0)/n.length;
  cz=z.reduce((a,b)=>a+b,0)/z.length;
  let ext=1;
  for(let i=0;i<n.length;i++)
    ext=Math.max(ext, Math.abs(e[i]-cx), Math.abs(n[i]-cy), Math.abs(z[i]-cz));
  scale=0.4*Math.min(innerWidth, innerHeight)/ext;
  tmin=Math.min(...t); tmax=Math.max(...t, tmin+1e-9); wmax=Math.max(...w,1e-30);
  pts={n,e,z,t,w}; draw();
 });
function color(u){ // dark blue -> yellow ramp
  const r=Math.round(40+215*u), g=Math.round(30+200*u), b=Math.round(120*(1-u)+40);
  return `rgb(${r},${g},${b})`;}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  if(!pts) return;
  const ca=Math.cos(rotZ), sa=Math.sin(rotZ), cb=Math.cos(rotX), sb=Math.sin(rotX);
  const proj=[], s=scale*zoom;
  for(let i=0;i<pts.n.length;i++){
    const x=pts.e[i]-cx, y=pts.n[i]-cy, zz=pts.z[i]-cz;
    const x1=ca*x-sa*y, y1=sa*x+ca*y;        // rotate about vertical
    const y2=cb*y1-sb*zz, z2=sb*y1+cb*zz;    // tilt
    proj.push([W/2+x1*s, H/2-y2*s, z2, i]);
  }
  proj.sort((a,b)=>a[2]-b[2]);
  for(const [px,py,pz,i] of proj){
    const u=(pts.t[i]-tmin)/(tmax-tmin);
    const r=2+5*Math.sqrt(pts.w[i]/wmax);
    ctx.fillStyle=color(u); ctx.beginPath();
    ctx.arc(px,py,r*zoom,0,6.283); ctx.fill();
  }
  // axes tripod (N green, E red, down blue)
  const axes=[[0,1,0,'#6c6','N'],[1,0,0,'#c66','E'],[0,0,1,'#66c','Z']];
  for(const [ax,ay,az,col,lab] of axes){
    const L=60, x1=ca*ax-sa*ay, y1=sa*ax+ca*ay;
    const y2=cb*y1-sb*az;
    ctx.strokeStyle=col; ctx.beginPath(); ctx.moveTo(70,H-70);
    ctx.lineTo(70+x1*L, H-70-y2*L); ctx.stroke();
    ctx.fillStyle=col; ctx.fillText(lab, 70+x1*L*1.15, H-70-y2*L*1.15);
  }
}
let dragging=false, lx=0, ly=0;
cv.addEventListener('mousedown',ev=>{dragging=true;lx=ev.clientX;ly=ev.clientY;});
addEventListener('mouseup',()=>dragging=false);
addEventListener('mousemove',ev=>{
  if(!dragging) return;
  rotZ+=(ev.clientX-lx)*0.01; rotX+=(ev.clientY-ly)*0.01;
  lx=ev.clientX; ly=ev.clientY; draw();});
cv.addEventListener('wheel',ev=>{zoom*=Math.exp(-ev.deltaY*0.001);draw();ev.preventDefault();});
</script></body></html>"""
