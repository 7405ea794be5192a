# Sphinx configuration for the fastsk-jax documentation site.
#
# Mirrors the reference's docs/conf.py role (a Sphinx site over the same
# content set: intro, API usage, data formats, FAQ, installation). This
# environment ships no sphinx/myst toolchain (zero egress, no installs),
# so the site is validated structurally: every page is plain
# Markdown/rST readable as-is, and `sphinx-build -b html docs docs/_build`
# works wherever sphinx + myst-parser are installed.

project = "fastsk-jax"
author = "fastsk-jax developers"
copyright = "2026, fastsk-jax developers"
release = "0.4.0"

extensions = [
    "myst_parser",          # Markdown sources
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

source_suffix = {
    ".rst": "restructuredtext",
    ".md": "markdown",
}

master_doc = "index"
exclude_patterns = ["_build", "demo.ipynb"]

html_theme = "alabaster"
html_title = "fastsk-jax: gapped k-mer string kernels in JAX"
