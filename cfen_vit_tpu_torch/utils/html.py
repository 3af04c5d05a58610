"""Minimal HTML gallery builder (counterpart of cfen_vit_tpu/utils/html.py;
replaces the reference's util/html.py dominate usage).

Same output layout: `<web_dir>/index.html` with an `images/` subdir,
headers per item and an image row with captions (ref util/html.py:6-49).
Plain string templating — no external deps.
"""

from __future__ import annotations

import html as _html
import os
from typing import List


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self.body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self.body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims: List[str], txts: List[str], links: List[str],
                   width: int = 400) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                '<td style="word-wrap:break-word" halign="center" '
                'valign="top"><p>'
                f'<a href="images/{link}"><img src="images/{im}" '
                f'style="width:{width}px"></a><br>'
                f'{_html.escape(str(txt))}</p></td>')
        self.body.append(
            '<table border="1" style="table-layout:fixed">'
            f'<tr>{"".join(cells)}</tr></table>')

    def save(self) -> None:
        refresh = (f'<meta http-equiv="refresh" content="{self.refresh}">'
                   if self.refresh else "")
        doc = ("<!DOCTYPE html><html><head>"
               f"<title>{_html.escape(self.title)}</title>{refresh}</head>"
               f"<body><h1>{_html.escape(self.title)}</h1>"
               + "".join(self.body) + "</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "wt") as fh:
            fh.write(doc)
