"""Global CSS injection (reference: ui/styles.py — same role, new styling)."""

CSS = """
<style>
:root {
  --accent: #6366f1;
  --accent2: #22d3ee;
  --card-bg: rgba(255, 255, 255, 0.04);
  --card-border: rgba(148, 163, 184, 0.25);
}

.hero-title {
  font-size: 2.0rem;
  font-weight: 800;
  background: linear-gradient(90deg, var(--accent), var(--accent2));
  -webkit-background-clip: text;
  background-clip: text;
  color: transparent;
  animation: hue 8s linear infinite;
  margin-bottom: 0.25rem;
}
@keyframes hue { to { filter: hue-rotate(360deg); } }

.sidebar-title { font-size: 1.1rem; font-weight: 700; margin-bottom: 0.5rem; }

.glow-frame {
  border: 1px solid var(--card-border);
  border-radius: 14px;
  padding: 2px;
  background: linear-gradient(135deg, rgba(99,102,241,.25), rgba(34,211,238,.12));
}
.glow-inner {
  border-radius: 12px;
  padding: 12px 16px;
  background: var(--card-bg);
  backdrop-filter: blur(8px);
}
.kpi { font-size: .75rem; letter-spacing: .08em; text-transform: uppercase; opacity: .7; }

.stat-grid { display: grid; grid-template-columns: repeat(auto-fit, minmax(160px, 1fr)); gap: 10px; }
.stat-card {
  border: 1px solid var(--card-border);
  border-radius: 12px; padding: 10px 14px;
  background: var(--card-bg); backdrop-filter: blur(6px);
}
.stat-card .value { font-size: 1.3rem; font-weight: 700; }
.stat-card .hint { font-size: .72rem; opacity: .65; }

.stepper { display: flex; flex-wrap: wrap; gap: 6px; margin: 6px 0 10px; }
.step-pill {
  border-radius: 999px; padding: 4px 12px; font-size: .8rem;
  border: 1px solid var(--card-border); background: var(--card-bg);
}
.step-pill.done { border-color: #22c55e; color: #22c55e; }
.step-pill.skip { opacity: .45; text-decoration: line-through; }
.step-pill.next { border-color: var(--accent); color: var(--accent); }

.status-chip {
  display: inline-block; border-radius: 8px; padding: 2px 10px;
  font-size: .78rem; border: 1px solid var(--card-border); margin-bottom: 6px;
}
.status-chip.done { border-color: #22c55e; color: #22c55e; }
.status-chip.todo { border-color: #eab308; color: #eab308; }

.file-tile {
  border: 1px solid var(--card-border); border-radius: 10px;
  padding: 8px 10px; background: var(--card-bg); font-size: .8rem;
  overflow: hidden; text-overflow: ellipsis; white-space: nowrap;
}
.file-tile .meta { opacity: .6; font-size: .7rem; }

.busy-indicator { font-weight: 600; }
.busy-dots span {
  display: inline-block; width: 6px; height: 6px; border-radius: 50%;
  background: var(--accent); margin-left: 3px;
  animation: bounce 1s infinite alternate;
}
.busy-dots span:nth-child(2) { animation-delay: .2s; }
.busy-dots span:nth-child(3) { animation-delay: .4s; }
@keyframes bounce { to { transform: translateY(-5px); opacity: .4; } }

.dir-tree { font-family: monospace; font-size: .8rem; line-height: 1.5; }
.dir-tree .dir { color: var(--accent2); }
</style>
"""


def inject_style():
    import streamlit as st

    st.markdown(CSS, unsafe_allow_html=True)
