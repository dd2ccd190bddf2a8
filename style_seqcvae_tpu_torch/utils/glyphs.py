"""The glyph atlas that ``utils/visualize.py`` draws label text with: the
printable ASCII characters (32-126) of Pillow's default font as Pillow
renders them, so that the port's labels are PIL's to the pixel without PIL.

The font is Aileron Regular, version 1.102, by Sora Sagano (dot-colon,
http://www.dotcolon.net), at size 10, as ``PIL.ImageFont.load_default()``
returns it (a ``FreeTypeFont``; ascent 10, descent 3). The masks were
rendered by Pillow 12.1.0 with FreeType 2.14.1 in ``"L"`` mode
(antialiased): for each character, ``font.getmask2(ch, "L")`` gives the
coverage mask (uint8, 0-255) and its offset from the pen position (x right,
y down from the top of the ascent), and ``font.getlength(ch)`` its advance,
a whole number of pixels for every character. The mask spans the glyph's
box joined with its pen line (a space is 2 x 0), as Pillow lays out a line.
``tests/test_torch_visualize.py`` renders the atlas again from Pillow and
holds it to this one byte for byte; run it as a script
(``python -m tests.test_torch_visualize --print-atlas``) to print a new
``_PACKED``.

Font licence. The copy of Aileron that Pillow bundles carries in its name
table the copyright notice "No Rights Reserved." (its author's dedication
to the public domain). Aileron is also distributed under the SIL Open Font
License, Version 1.1, whose notice reads: "This Font Software is licensed
under the SIL Open Font License, Version 1.1. This license is available
with a FAQ at: https://openfontlicense.org". What is stored here is the
font's rendering at one size, not its outlines.

Layout of ``_PACKED`` (base64 of zlib): for each character in code order,
five bytes ``<BBbbB`` (mask width, mask height, x offset, y offset,
advance), then the mask's height x width bytes, row by row.
"""

from __future__ import annotations

import base64
import struct
import zlib
from typing import Dict, NamedTuple

import numpy as np

PILLOW_VERSION = "12.1.0"
FREETYPE_VERSION = "2.14.1"
FONT = "Aileron Regular 1.102"
SIZE = 10
# PIXEL(ascender) of the font at this size: the line's anchor "la" puts the
# pen's y origin this far below the top
ASCENT = 10
FIRST, LAST = 32, 126

_PACKED = (
    "eNqNVwtYVNUW/uecOTPMIA9TxBeWgqIillfxlaIGiEEoKL4l0dQ00xILNU2z1MJuPr+0tBRRVHyBXkGeM2ceApEI"
    "hqhZ+vkGFWskEzRu3rX3GRBT8M53Zq191t5rrb3XXq8jAHpBdIAgwoZ/Po5AOuyTNvYUFODJn4YmNcDiduvp5esO"
    "8xkcGgbEn/3hoAu83t8I9DtTdP1bIK7NSjYZGA5o9VBp6WUhk+C85OFiekmdfXcRyahoYtO/A+zf92dzJn3OX+WR"
    "bJHN5zIga2yuvwAjTQ8tgZxIfy3p1y48/SGEVNcy5zLMmIorXpdfSFUhKn/Cpl5sWc9NY1IjoUptdqnlRbw1Ezdb"
    "lbumC1hY+iFnxivpOSZv4Iw3P1CJD3AB8K0olWsO48B7Kqbmjsi1Fb/KkZ8sGwqgImaVzaYYRE0nUgOhEtwTgY8m"
    "AOb2QDmx3aHZ805AQj9g2CeAKlFS6x+pROl1mkh0ByYuAjxNJKIMfLXzeTJZArA8GNJOOqAESWs/LCYE2gLHAbrY"
    "8vkOdG8pbsl6ktgKrVTQaqCuW2dHm+QaeRP+QVR+ovjIQUAn+BqxOhyiGhpxhRxRNy0IcBCaIBOS7hFdPvC9QFvZ"
    "TINhYwisdWEk+ndlFx7LLPcdY3uj1iNcUqwpLlgdg/lf4HRrtCnBbQHCLTtUKGw2DspKxY1c4++SAMscts+W9t02"
    "AhWmqZbioXAzCZ3PovNoON5ik5PZ3jxPuwFNTvQhCx0cT+9T7snyUYVJnyQXhiL2A7S6hKYaBJJXYeefAYx1RAI2"
    "qiHeQUIkBuaindGU1bnWyxFSRcApt5I58hjawYBk2oc2vzXBCaWyXJNQf3+cKeiiLK9A1ExGih3B4Not1iOeWDMb"
    "Iw14SYR4G3tHoL8BHa1yuqfCJGzIM3fAOysRcQjHvaCJxe0YOfkl3B2FUTk4z5m+GYIh2WjxH2OWnWmvLOdWMAXT"
    "PiWgKmpBcPgWRmDejT6H2fCgPwGvvLrIDcg1WvrhUnt4nkFhL/S+DL/qkuo3YBqF0dvwmwCxAnkDMeAEXjaZ5FcU"
    "pvYZ8lF3ZAUgYDNu02Z+Rk4EIm1on2ycfwsfaegoOBSOlbPhZc3bKDDTqYUMOHG7MKcStY/UAjJgJ9FeNmLIx1g1"
    "CBpaygyNAfTvuGM58O817CD75jPfRkhaNHfeGdBQWGi8ZfrZRdQf24VyWQP5eOXOjgy1/noNQWn2XmBcSggNpzPf"
    "VtOh1APyC9842anV+WhoKBB7HQE+owjdq2KeCNqzXgeBgg3j06zpg5isbQnN4HOGMsyEJNekrPXD08jQPb+b2vFX"
    "xxsgs1xz6LZHoqRV4XzN8cuPIigBpodPSpq5fx2duf+vfSFFvsak9D7yQ/bbopLH6ODTHrgz6uEvpxDUZ3sfJBTx"
    "AQppKr44vywIYi4QvB7+FIr6s/hqNLveLop73pdNRWHM+16+zKDqAoMBYUTPq8lkY18bg60LiWIw9FKS3/STplQP"
    "BBl0eD0HGX1J3BbpGrc1yhRkYgG0A2OztBhPdlty2pjUXEm7JMd4PFopFDmjud/3tHIklXOku8rRoDSGmuYPZgzW"
    "CNRuV5ZjnhHYjN7vKcrnz2fyfpqubHNGQW5aWwQdk7AgAxl+5HYpov2M5VrEyOdgIaJrFaJoyeJ7UK06mzPFBgdi"
    "dlDk2NAgZprl+w3ON1RZbXUZ4jlJzsxhqYfnOSovhSdC7J5CNI8iliMdrH3ZivhpbPncb7gxfk5h6A/nrJlcRtvr"
    "XbiQ8cVaTS1z40of29VqtcbpiEmHqn30vosSoO2UCFUeO8D2vujxLRuMW4aFI9ngBQsynfnZTB6ZyiEXJcQqg+5/"
    "d0OtVauMditZBiv4NZPdJqYhCh5stpvJ+JqC/S12q+ZU2e91SmFe4WQEW13hag3MpvqK/lnXqS7C4TpHumtZ/Qm9"
    "mjHU6kJLAjD1ZF5hdJ37Ga1+PCp+5FIreLRksyg68tIzPEln13hiol2jv6IxTdF4WdF4J5NrtAQwjZZQTD7xQ2Xl"
    "HC6m+WBtbZieHMSl+v7EkeoOR8H7mTMdv9OSv8Uu5KjHIY70vwrKrv+VaczyQHFbjErCDS9IAxFd9v0Qkt50yqlP"
    "3Ei3W3nzax7oXICQfGN2N64xggqTLEc+1QY8DylGtj1254bQbyLUVHkyhiH0GNDJZDJ1Urx09Vssdb7sf4DS/jmI"
    "F9QIX0dNzwBspS2PW4kSaplc83vwqmnYOJKhmD+o59QTsz6ectuptcC6yBmr4VRIeS/PvZsBQZ8Va6VTUF1SLRv6"
    "fV8/ajvSvVOd3nr/3TeBpVEGdNm7kzqvwOwNUBUaWL35ixqWo4n2DBtM9vQpEHHUH5kUN955o7YyreuuNOMp/eKL"
    "7PYOBlGtVBd0wMERiFkFtDvryJm7llATdKIb9oxDaBLQpUSwdmVN3NbdvAD917tRQ34ly5aHnPbe57wWnWLlBEmh"
    "DAYfYNChqC1Dn8XwZQ8slFmasM5SxDlZrLV2g39aw7s1FS/6G5j08DBmAdaa824Nc19hfdFiNtzOQJjAe1GRUiCe"
    "I5+t0WghUr4K7MqNxUppv7fXUCu4uemrs+BE17j/iQIsqaCXoukQ0SIxir0W4OmfREVa8rGenofNA1+4AafpcfeQ"
    "Pr1tJSpcvB7g09LdN5+Vs760UHtdNRaTknFfA2057onQXkZ1GCbFwxZvPuLG5TY/JGe22DEeUzZf00B04QXt8BhM"
    "+9yTgtz1qezrfsQSb8POiQivxlUt1H/iphaa+0geg7FVaG82f2FTmoqmu7LNvfFdH7QrxlU63y9iGcnyx4HxLAI8"
    "jplyOkCtY/fWeYELzs51xO/ArBq5ybNsS9tQa0j1zorGVMdVIL47/Mzoac4wdqsXm/VcbaWphDr4qnnodAWodgWo"
    "m658RsDymuQzC48rVb1H1NNk78kNTP6OpEQ8q4i0+MkHNo2BehrbVhb1VXkssGxC1nQ263ahdyOF8MdFOg2zl23b"
    "hZm7Ls6jvfdp93fvF6mNui+iWmioeiqP8t1DZz9FZ78/Dx0aPzv3i5Zp5rSWiVGI2nVdC+31GwwkTsTExNbHzMda"
    "8Qv5f3ysvglqb/G5DlTfaKRGraYyOhdVwcA94Qm/kDSPaHJO0cmhuOXUOQHxyUE04X9ou4tJcryJDwuL3lVsyivF"
    "8prMx1apFJB61G6Yp2xQyR/XauCqD2ZTPY8oNcYpji0Vt4H2vLBkFoZtgHc6vqYu/EfnXOqBl6xax1LcA6owDrTQ"
    "4ecXkbEeg/esjxKyTFj65utbu6/OcMp21xXPHL48zEJJObNZkHEF8H4pnGoGkPRHaol9FGyJQtsiv2Ms09+gPI2l"
    "V3ypZJi7m1Qw9MemacyOUpEXnH9R0efZ2Dh4mLGbspbchgoAZiV9zCrpQy+CHtnsA6eoR12nv0m2/sXsuoS+GuBb"
    "IFEOz2f57uNPGPXhcVnWiTyZrl8Gm1oxR+h+hKTUmuYuTS0VHdmSRl1OiRKVuGwt1HW0faHYHWKftGHpWmjUbF9x"
    "hhG+07HC+Yuc9vXT3v8AJSWS+Q=="
)


class Glyph(NamedTuple):
    mask: np.ndarray          # (h, w) uint8 coverage
    x: int                    # mask's offset from the pen position
    y: int                    # mask's offset below the top of the ascent
    advance: int              # whole pixels


def _unpack() -> Dict[str, Glyph]:
    data = zlib.decompress(base64.b64decode("".join(_PACKED)))
    glyphs, pos = {}, 0
    for code in range(FIRST, LAST + 1):
        w, h, x, y, advance = struct.unpack_from("<BBbbB", data, pos)
        pos += 5
        mask = np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w)
        mask.flags.writeable = False
        glyphs[chr(code)] = Glyph(mask, x, y, advance)
        pos += w * h
    if pos != len(data):
        raise ValueError("the glyph atlas is corrupt")
    return glyphs


GLYPHS: Dict[str, Glyph] = _unpack()
