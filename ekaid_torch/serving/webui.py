"""Browser demo client: the page the HTTP server serves at GET / (the
port's own copy of `ekaid_tpu/serving/webui.py`).

A self-contained page (no dependencies) over the server's endpoints
(/question /refresh /sample /image /health): the study pair, a question
box and the answer, with each generated token's module attention (the
[T, 3] before/difference/after softmax of the decoder step) as a small
stacked bar; exact weights are available as text (hover tooltip and a
table toggle).
"""

PAGE_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>EKAID demo</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --surface-2: #f1f0ee;
    --border: #dddcd8;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --series-1: #2a78d6;  /* before  */
    --series-2: #eb6834;  /* difference */
    --series-3: #1baf7a;  /* after   */
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --surface-2: #262624;
      --border: #3a3936;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --series-1: #3987e5;
      --series-2: #d95926;
      --series-3: #199e70;
    }
  }
  body.viz-root {
    margin: 0; padding: 24px; background: var(--surface-1);
    color: var(--text-primary);
    font: 14px/1.45 system-ui, -apple-system, sans-serif;
    max-width: 960px; margin-inline: auto;
  }
  h1 { font-size: 18px; margin: 0 0 4px; }
  .sub { color: var(--text-secondary); margin-bottom: 16px; }
  .row { display: flex; gap: 16px; flex-wrap: wrap; }
  .card {
    background: var(--surface-2); border: 1px solid var(--border);
    border-radius: 8px; padding: 14px 16px; margin-bottom: 14px;
    flex: 1 1 280px;
  }
  .card h2 {
    font-size: 12px; letter-spacing: .04em; text-transform: uppercase;
    color: var(--text-secondary); margin: 0 0 8px; font-weight: 600;
  }
  .imgbox { text-align: center; }
  .imgbox img {
    max-width: 100%; max-height: 320px; border-radius: 4px;
    background: var(--surface-1);
  }
  .imgbox .missing { color: var(--text-secondary); padding: 40px 0; }
  label { color: var(--text-secondary); }
  input[type=text] {
    width: 100%; box-sizing: border-box; padding: 8px 10px;
    border: 1px solid var(--border); border-radius: 6px;
    background: var(--surface-1); color: var(--text-primary);
    font: inherit; margin: 6px 0 10px;
  }
  button {
    padding: 7px 14px; border: 1px solid var(--border);
    border-radius: 6px; background: var(--surface-1);
    color: var(--text-primary); font: inherit; cursor: pointer;
  }
  button.primary { background: var(--series-1); border-color: var(--series-1);
                   color: #fff; }
  .answer { font-size: 16px; margin: 10px 0 4px; }
  .meta { color: var(--text-secondary); font-size: 12px; }
  .legend { display: flex; gap: 14px; margin: 10px 0 8px;
            color: var(--text-secondary); font-size: 12px; }
  .legend .sw { display: inline-block; width: 10px; height: 10px;
                border-radius: 2px; margin-right: 5px;
                vertical-align: -1px; }
  .chips { display: flex; flex-wrap: wrap; gap: 10px; }
  .chip { text-align: center; }
  .chip .w { font-size: 13px; }
  .bar { display: flex; width: 64px; height: 8px; margin-top: 3px;
         gap: 2px; }  /* 2px surface gap between stacked segments */
  .bar span { border-radius: 2px; min-width: 1px; }
  .bar .s1 { background: var(--series-1); }
  .bar .s2 { background: var(--series-2); }
  .bar .s3 { background: var(--series-3); }
  table { border-collapse: collapse; margin-top: 8px; font-size: 13px; }
  th, td { border: 1px solid var(--border); padding: 4px 10px;
           text-align: right; }
  th { color: var(--text-secondary); font-weight: 600; }
  td:first-child, th:first-child { text-align: left; }
  #tooltip {
    position: fixed; pointer-events: none; display: none; z-index: 10;
    background: var(--surface-2); border: 1px solid var(--border);
    border-radius: 6px; padding: 6px 9px; font-size: 12px;
    box-shadow: 0 2px 8px rgba(0,0,0,.18);
  }
  #health { margin-top: 6px; }
</style>
</head>
<body class="viz-root">
<h1>EKAID &mdash; difference VQA demo</h1>
<div class="sub">Ask a free-form question about a chest-X-ray study
pair; the decoder's per-token module attention
(before&thinsp;/&thinsp;difference&thinsp;/&thinsp;after) is shown
under each generated word.</div>

<div class="row">
  <div class="card imgbox"><h2>Main study</h2><div id="img_main"></div></div>
  <div class="card imgbox"><h2>Reference study</h2><div id="img_ref"></div></div>
</div>

<div class="card">
  <h2>Study pair <span id="pair_idx"></span></h2>
  <div id="gt" class="meta"></div>
  <div style="margin-top:10px">
    <button id="refresh">New random pair</button>
  </div>
</div>

<div class="card">
  <h2>Question</h2>
  <input type="text" id="q" placeholder="what abnormalities are seen in this image?">
  <button class="primary" id="ask">Ask</button>
  <div class="answer" id="answer"></div>
  <div class="meta" id="latency"></div>
  <div id="attn" style="display:none">
    <div class="legend">
      <span><span class="sw" style="background:var(--series-1)"></span>before</span>
      <span><span class="sw" style="background:var(--series-2)"></span>difference</span>
      <span><span class="sw" style="background:var(--series-3)"></span>after</span>
      <button id="tbl_toggle" style="margin-left:auto">table</button>
    </div>
    <div class="chips" id="chips"></div>
    <div id="tbl" style="display:none"></div>
  </div>
</div>

<div class="meta" id="health"></div>
<div id="tooltip"></div>

<script>
"use strict";
const $ = id => document.getElementById(id);
const NAMES = ["before", "difference", "after"];
const tooltip = $("tooltip");
// escape server-provided strings before innerHTML interpolation
// (the decoder can emit a literal "<unk>" token; dataset text may
// contain markup)
const esc = s => String(s).replace(/[&<>"']/g, c => ({
  "&": "&amp;", "<": "&lt;", ">": "&gt;",
  '"': "&quot;", "'": "&#39;"}[c]));

async function api(path, body) {
  const r = await fetch(path, body === undefined ? {} :
    {method: "POST", headers: {"Content-Type": "application/json"},
     body: JSON.stringify(body)});
  return r.json();
}

function setImage(el, which, idx) {
  el.innerHTML = "";
  const img = new Image();
  img.src = `/image?which=${which}&index=${idx}&t=${idx}`;
  img.alt = which + " study image";
  img.onerror = () => { el.innerHTML =
    '<div class="missing">no image (server started without --image_dir)</div>'; };
  el.appendChild(img);
}

async function loadPair() {
  const s = await api("/sample");
  $("pair_idx").textContent = "#" + s.index;
  $("gt").innerHTML = s.error ? esc(s.error) :
    `dataset question: &ldquo;${esc(s.question)}&rdquo;<br>` +
    `ground-truth answer: &ldquo;${esc(s.gt_answer)}&rdquo;`;
  setImage($("img_main"), "main", s.index);
  setImage($("img_ref"), "ref", s.index);
}

function chip(word, w) {
  const div = document.createElement("div");
  div.className = "chip";
  const total = w[0] + w[1] + w[2] || 1;
  let bar = "";
  for (let k = 0; k < 3; k++)
    bar += `<span class="s${k+1}" style="flex:${(w[k]/total).toFixed(4)}"></span>`;
  div.innerHTML = `<div class="w">${esc(word)}</div><div class="bar">${bar}</div>`;
  div.addEventListener("mousemove", e => {
    tooltip.style.display = "block";
    tooltip.style.left = (e.clientX + 12) + "px";
    tooltip.style.top = (e.clientY + 12) + "px";
    tooltip.innerHTML = `<b>${esc(word)}</b><br>` + NAMES.map(
      (n, k) => `${n}: ${w[k].toFixed(3)}`).join("<br>");
  });
  div.addEventListener("mouseleave", () => {
    tooltip.style.display = "none"; });
  return div;
}

function renderAttention(tokens, weights) {
  const box = $("attn"), chips = $("chips"), tbl = $("tbl");
  chips.innerHTML = ""; tbl.innerHTML = "";
  if (!tokens || !tokens.length) { box.style.display = "none"; return; }
  box.style.display = "";
  tokens.forEach((t, i) => chips.appendChild(chip(t, weights[i])));
  let rows = tokens.map((t, i) =>
    `<tr><td>${esc(t)}</td>` + weights[i].map(
      v => `<td>${v.toFixed(3)}</td>`).join("") + "</tr>").join("");
  tbl.innerHTML = `<table><tr><th>token</th><th>before</th>` +
    `<th>difference</th><th>after</th></tr>${rows}</table>`;
}

$("ask").onclick = async () => {
  const q = $("q").value.trim();
  if (!q) return;
  $("answer").textContent = "…";
  const r = await api("/question", {question: q, detail: true});
  if (r.error) { $("answer").textContent = "error: " + r.error; return; }
  $("answer").textContent = r.answer || "(empty answer)";
  $("latency").textContent = `index #${r.index} · ${r.latency_ms} ms`;
  renderAttention(r.tokens, r.module_weights);
};
$("q").addEventListener("keydown", e => {
  if (e.key === "Enter") $("ask").click(); });
$("refresh").onclick = async () => {
  await api("/refresh", {});
  $("answer").textContent = ""; $("latency").textContent = "";
  $("attn").style.display = "none";
  loadPair();
};
$("tbl_toggle").onclick = () => {
  const t = $("tbl");
  t.style.display = t.style.display === "none" ? "" : "none";
};

async function health() {
  try {
    const h = await api("/health");
    let s = `server ok · vocab ${h.vocab_size}`;
    if (h.coalescing) s += ` · coalescing: ${h.coalescing.requests} ` +
      `requests in ${h.coalescing.batches} batches`;
    $("health").textContent = s;
  } catch (e) { $("health").textContent = "server unreachable"; }
}

loadPair(); health(); setInterval(health, 10000);
</script>
</body>
</html>
"""
