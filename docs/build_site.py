#!/usr/bin/env python
"""Build the HTML docs site from the markdown sources (no sphinx).

This environment has no sphinx wheel and no network, so the sphinx
scaffolding (conf.py/index.rst) cannot run here; this builder produces
the actual site instead using what IS available: python-markdown (with
fenced-code + tables + toc), pygments highlighting, a jinja2 layout, and
nbconvert for the demo notebook. Reference analogue: the reference's
sphinx site (/root/reference/docs/conf.py) — same pages-from-sources
model, different generator.

    python docs/build_site.py          # writes docs/_build/html/
    python docs/build_site.py --check  # also fail on broken local links

The sidebar order mirrors index.rst's toctrees, so environments that do
have sphinx build the same structure from the same sources.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

import jinja2
import markdown

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "_build", "html")

# (source, title) in index.rst toctree order; index.md is the landing page
PAGES = [
    ("index.md", "Overview"),
    ("installation.md", "Installation"),
    ("api_usage.md", "API usage"),
    ("data_formats.md", "Data formats"),
    ("faq.md", "FAQ"),
    ("demo.md", "Demo walkthrough"),
    ("migrating_from_fastsk.md", "Migrating from FastSK"),
    ("design.md", "Design"),
    ("scaling.md", "Multi-chip scaling"),
    ("CHANGELOG.md", "Changelog"),
]

LAYOUT = jinja2.Template(
    """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{{ title }} — fastsk-jax</title>
<style>
 body { margin: 0; font: 16px/1.55 system-ui, sans-serif; color: #1a1a1a; }
 .wrap { display: flex; min-height: 100vh; }
 nav { width: 230px; flex-shrink: 0; background: #f6f8fa;
       border-right: 1px solid #d8dee4; padding: 1.2rem 1rem; }
 nav h1 { font-size: 1.05rem; margin: 0 0 .8rem; }
 nav a { display: block; color: #0969da; text-decoration: none;
         padding: .18rem 0; font-size: .92rem; }
 nav a.current { font-weight: 600; color: #1a1a1a; }
 main { padding: 1.5rem 2.5rem; max-width: 56rem; min-width: 0; }
 pre { background: #f6f8fa; padding: .8rem 1rem; overflow-x: auto;
       border-radius: 6px; font-size: .88rem; }
 code { font-family: ui-monospace, monospace; font-size: .92em; }
 :not(pre) > code { background: #f0f2f4; padding: .1em .3em;
       border-radius: 4px; }
 table { border-collapse: collapse; display: block; overflow-x: auto; }
 th, td { border: 1px solid #d8dee4; padding: .35rem .6rem;
       font-size: .92rem; }
 th { background: #f6f8fa; }
 h1, h2, h3 { line-height: 1.25; }
 a { color: #0969da; }
 {{ pygments_css }}
</style></head><body><div class="wrap">
<nav><h1>fastsk-jax</h1>
{% for href, t in nav %}<a href="{{ href }}"
 {% if href == current %}class="current"{% endif %}>{{ t }}</a>{% endfor %}
<a href="demo_notebook.html" {% if current == 'demo_notebook.html' %}
 class="current"{% endif %}>Demo notebook (executed)</a>
</nav>
<main>{{ body }}</main>
</div></body></html>
"""
)


def build(check: bool = False) -> int:
    shutil.rmtree(os.path.join(HERE, "_build"), ignore_errors=True)
    os.makedirs(OUT)
    nav = [(src.replace(".md", ".html"), t) for src, t in PAGES]
    written, errors = [], []

    try:
        from pygments.formatters import HtmlFormatter

        pyg_css = HtmlFormatter().get_style_defs(".codehilite")
    except Exception:
        pyg_css = ""

    md = markdown.Markdown(
        extensions=["fenced_code", "tables", "toc", "codehilite"],
        extension_configs={"codehilite": {"guess_lang": False}},
    )
    for src, title in PAGES:
        path = os.path.join(HERE, src)
        if not os.path.exists(path):
            errors.append(f"missing source: {src}")
            continue
        text = open(path).read()
        md.reset()
        body = md.convert(text)
        # .md -> .html for intra-site links
        body = re.sub(
            r'href="([\w./-]+)\.md(#[\w-]*)?"', r'href="\1.html\2"', body
        )
        out = src.replace(".md", ".html")
        with open(os.path.join(OUT, out), "w") as f:
            f.write(
                LAYOUT.render(
                    title=title, body=body, nav=nav, current=out,
                    pygments_css=pyg_css,
                )
            )
        written.append(out)

    # executed demo notebook via nbconvert
    nb = os.path.join(HERE, "demo.ipynb")
    if os.path.exists(nb):
        try:
            from nbconvert import HTMLExporter

            html, _ = HTMLExporter().from_filename(nb)
            with open(os.path.join(OUT, "demo_notebook.html"), "w") as f:
                f.write(html)
            written.append("demo_notebook.html")
        except Exception as e:  # keep the md site even if nbconvert breaks
            errors.append(f"nbconvert failed: {e}")

    if check:
        site = {w for w in written}
        for w in written:
            if not w.endswith(".html") or w == "demo_notebook.html":
                continue
            text = open(os.path.join(OUT, w)).read()
            for target in re.findall(r'href="([\w./-]+\.html)', text):
                t = target.split("#")[0]
                if "/" not in t and t not in site:
                    errors.append(f"{w}: broken link -> {target}")

    index = os.path.join(OUT, "index.html")
    print(f"built {len(written)} pages -> {OUT}")
    for e in errors:
        print(f"ERROR: {e}", file=sys.stderr)
    if not errors:
        print(f"site OK: open {index}")
    return 1 if errors else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    sys.exit(build(check=args.check))
