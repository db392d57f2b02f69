"""TPC-H data made on the device from the seed, in the encoded form.

Begun as a frozen copy of the program's TPC-H generator (its
``generate``) and brought to dbgen's rules (TPC-H v3 section 4.2.3):
sparse orderkeys (eight used in every 32), dbgen's part-supplier
bridge, retail price, clerk count and total price, part names of five
distinct colours of 92, and addresses and phones random per row. Every
column is drawn with torch on the device and emitted encoded: int64 keys,
int64 cents for DECIMAL, int32 day numbers for DATE and int32 dictionary
codes with each dictionary's values for strings. One departure is left:
comments are words of a 28-word list, as the program's generator makes
them, where dbgen draws random text (no template of the mixes reads a
comment but Q10, which only returns it).

``make(scale, seed, device, tables)`` returns the tables asked for (and
what they depend on) as ``common.Table``. At scale 1 orders has 1,500,000
rows with one to seven lines each (about six million lineitem rows).
"""

from __future__ import annotations

import torch

from cbbench.gen.common import (Streams, Table, days, digits, encode,
                                encode_chars, fixed, phrase_values, rand,
                                randint, v_string, words)

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
              for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM"]]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_NAMES = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "burnished", "chartreuse", "chiffon", "chocolate", "coral",
           "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
           "dodger", "drab", "firebrick", "floral", "forest", "frosted",
           "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
           "hot", "hotpink", "indian", "ivory", "khaki", "lace", "lavender",
           "lawn", "lemon", "light", "lime", "linen", "magenta", "maroon",
           "medium", "metallic", "midnight", "mint", "misty", "moccasin",
           "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
           "peach", "peru", "pink", "plum", "powder", "puff", "purple",
           "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
           "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
           "steel", "tan", "thistle", "tomato", "turquoise", "violet",
           "wheat", "white", "yellow"]
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
# the characters of a V-string (dbgen's alpha-numeric set, 64 symbols)
ALNUM = ("0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
         ",.")
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
WORDS = ["carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
         "final", "special", "pending", "regular", "express", "bold",
         "even", "silent", "daring", "unusual", "packages", "deposits",
         "requests", "accounts", "theodolites", "instructions", "platelets",
         "foxes", "ideas", "dependencies", "pinto beans", "warhorses"]

CURRENT = days("1995-06-17")
ORDER_START, ORDER_END = days("1992-01-01"), days("1998-08-02")

# the tables each table is made with
_GROUP = {"orders": "orders", "lineitem": "orders", "part": "part",
          "partsupp": "part", "supplier": "supplier", "customer": "customer",
          "nation": "nation", "region": "region"}

I64, I32, DEC, DATE, STR = "int64", "int32", "decimal", "date", "string"


def sizes(scale: float) -> dict[str, int]:
    return {"supplier": max(int(10_000 * scale), 10),
            "customer": max(int(150_000 * scale), 30),
            "part": max(int(200_000 * scale), 40),
            "orders": max(int(1_500_000 * scale), 150)}


def _comment(g, n, nwords):
    return encode(words(g, n, nwords, len(WORDS)),
                  lambda u: phrase_values(u, nwords, WORDS))


def _numbered(prefix: str, width: int):
    return lambda u: [f"{prefix}{int(i):0{width}d}" for i in u]


def _cents(g, lo: int, hi: int, n: int) -> torch.Tensor:
    """DECIMAL(2) draws in [lo, hi] cents."""
    return randint(g, lo, hi + 1, n)


def retail_cents(pk: torch.Tensor) -> torch.Tensor:
    return 90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)


def supplier_of(pk: torch.Tensor, i, n_supp: int) -> torch.Tensor:
    """dbgen's part-supplier bridge: the ``i``-th (0..3) supplier of each
    part."""
    return (pk + i * (n_supp // 4 + (pk - 1) // n_supp)) % n_supp + 1


def order_keys(i: torch.Tensor) -> torch.Tensor:
    """dbgen's sparse orderkeys: of every 32 keys the first eight."""
    return (i // 8) * 32 + i % 8 + 1


def _address(g, n):
    return encode_chars(v_string(g, n, 10, 40, ALNUM))


def _phone(g, nat: torch.Tensor) -> tuple[torch.Tensor, list[str]]:
    """TPC-H's phone: country code (nation + 10), then three random local
    numbers of 3, 3 and 4 digits, joined by dashes."""
    n = nat.shape[0]
    dash = torch.full((n, 1), ord("-"), dtype=torch.int64, device=nat.device)
    chars = torch.cat([digits(nat + 10, 2), dash,
                       digits(randint(g, 100, 1000, n), 3), dash,
                       digits(randint(g, 100, 1000, n), 3), dash,
                       digits(randint(g, 1000, 10000, n), 4)], dim=1)
    return encode_chars(chars)


def _region(s: Streams, dev) -> Table:
    c, d = _comment(s("region"), 5, 4)
    code, vals = fixed(torch.arange(5, device=dev), REGIONS)
    return Table([("r_regionkey", I64, 0), ("r_name", STR, 0),
                  ("r_comment", STR, 0)],
                 {"r_regionkey": torch.arange(5, device=dev),
                  "r_name": code, "r_comment": c},
                 {"r_name": vals, "r_comment": d})


def _nation(s: Streams, dev) -> Table:
    c, d = _comment(s("nation"), 25, 4)
    code, vals = fixed(torch.arange(25, device=dev), [n for n, _ in NATIONS])
    return Table([("n_nationkey", I64, 0), ("n_name", STR, 0),
                  ("n_regionkey", I64, 0), ("n_comment", STR, 0)],
                 {"n_nationkey": torch.arange(25, device=dev),
                  "n_name": code,
                  "n_regionkey": torch.tensor([r for _, r in NATIONS],
                                              dtype=torch.int64, device=dev),
                  "n_comment": c},
                 {"n_name": vals, "n_comment": d})


def _supplier(s: Streams, dev, n: int) -> Table:
    g = s("supplier")
    sk = torch.arange(1, n + 1, device=dev)
    addr, addr_d = _address(g, n)
    nat = randint(g, 0, 25, n)
    phone, phone_d = _phone(g, nat)
    bal = _cents(g, -99999, 999999, n)
    com, com_d = _comment(g, n, 4)
    name, name_d = encode(sk, _numbered("Supplier#", 9))
    return Table([("s_suppkey", I64, 0), ("s_name", STR, 0),
                  ("s_address", STR, 0), ("s_nationkey", I64, 0),
                  ("s_phone", STR, 0), ("s_acctbal", DEC, 2),
                  ("s_comment", STR, 0)],
                 {"s_suppkey": sk, "s_name": name, "s_address": addr,
                  "s_nationkey": nat, "s_phone": phone, "s_acctbal": bal,
                  "s_comment": com},
                 {"s_name": name_d, "s_address": addr_d, "s_phone": phone_d,
                  "s_comment": com_d})


def _customer(s: Streams, dev, n: int) -> Table:
    g = s("customer")
    ck = torch.arange(1, n + 1, device=dev)
    addr, addr_d = _address(g, n)
    nat = randint(g, 0, 25, n)
    phone, phone_d = _phone(g, nat)
    bal = _cents(g, -99999, 999999, n)
    seg, seg_d = fixed(randint(g, 0, 5, n), SEGMENTS)
    com, com_d = _comment(g, n, 4)
    name, name_d = encode(ck, _numbered("Customer#", 9))
    return Table([("c_custkey", I64, 0), ("c_name", STR, 0),
                  ("c_address", STR, 0), ("c_nationkey", I64, 0),
                  ("c_phone", STR, 0), ("c_acctbal", DEC, 2),
                  ("c_mktsegment", STR, 0), ("c_comment", STR, 0)],
                 {"c_custkey": ck, "c_name": name, "c_address": addr,
                  "c_nationkey": nat, "c_phone": phone, "c_acctbal": bal,
                  "c_mktsegment": seg, "c_comment": com},
                 {"c_name": name_d, "c_address": addr_d,
                  "c_phone": phone_d, "c_mktsegment": seg_d,
                  "c_comment": com_d})


def _part(s: Streams, dev, n: int, n_supp: int) -> dict[str, Table]:
    g = s("part")
    pk = torch.arange(1, n + 1, device=dev)
    # five distinct colours of the 92, in a random order
    pick = torch.rand((n, len(P_NAMES)), generator=g, device=dev).topk(
        5, dim=1).indices
    code = torch.zeros((n,), dtype=torch.int64, device=dev)
    for k in range(5):
        code = code * len(P_NAMES) + pick[:, k]
    name, name_d = encode(code, lambda u: phrase_values(u, 5, P_NAMES))
    mfgr_n = randint(g, 1, 6, n)
    brand_n = mfgr_n * 10 + randint(g, 1, 6, n)
    mfgr, mfgr_d = encode(mfgr_n, _numbered("Manufacturer#", 1))
    brand, brand_d = encode(brand_n, _numbered("Brand#", 2))
    t1, t2, t3 = randint(g, 0, 6, n), randint(g, 0, 5, n), randint(g, 0, 5, n)
    ptype, ptype_d = encode(
        t1 * 25 + t2 * 5 + t3,
        lambda u: [f"{TYPE_1[c // 25]} {TYPE_2[(c // 5) % 5]} "
                   f"{TYPE_3[c % 5]}" for c in u.tolist()])
    size = randint(g, 1, 51, n).to(torch.int32)
    cont, cont_d = fixed(randint(g, 0, len(CONTAINERS), n), CONTAINERS)
    com, com_d = _comment(g, n, 2)
    part = Table([("p_partkey", I64, 0), ("p_name", STR, 0),
                  ("p_mfgr", STR, 0), ("p_brand", STR, 0), ("p_type", STR, 0),
                  ("p_size", I32, 0), ("p_container", STR, 0),
                  ("p_retailprice", DEC, 2), ("p_comment", STR, 0)],
                 {"p_partkey": pk, "p_name": name, "p_mfgr": mfgr,
                  "p_brand": brand, "p_type": ptype, "p_size": size,
                  "p_container": cont, "p_retailprice": retail_cents(pk),
                  "p_comment": com},
                 {"p_name": name_d, "p_mfgr": mfgr_d, "p_brand": brand_d,
                  "p_type": ptype_d, "p_container": cont_d,
                  "p_comment": com_d})
    g = s("partsupp")
    ps_pk = pk.repeat_interleave(4)
    m = ps_pk.shape[0]
    which = torch.arange(4, device=dev).repeat(n)
    ps_sk = supplier_of(ps_pk, which, n_supp)
    avail = randint(g, 1, 10_000, m).to(torch.int32)
    cost = _cents(g, 100, 100_000, m)
    com, com_d = _comment(g, m, 4)
    partsupp = Table([("ps_partkey", I64, 0), ("ps_suppkey", I64, 0),
                      ("ps_availqty", I32, 0), ("ps_supplycost", DEC, 2),
                      ("ps_comment", STR, 0)],
                     {"ps_partkey": ps_pk, "ps_suppkey": ps_sk,
                      "ps_availqty": avail, "ps_supplycost": cost,
                      "ps_comment": com},
                     {"ps_comment": com_d})
    return {"part": part, "partsupp": partsupp}


def _orders(s: Streams, dev, sz: dict[str, int],
            scale: float) -> dict[str, Table]:
    n_ord, n_cust = sz["orders"], sz["customer"]
    n_part, n_supp = sz["part"], sz["supplier"]
    g = s("orders")
    ok = order_keys(torch.arange(n_ord, device=dev))
    # dbgen's rule: customers whose key is a multiple of 3 place no order;
    # pool index j is the j-th such key: j + j // 2 + 1
    j = randint(g, 0, n_cust - n_cust // 3, n_ord)
    o_cust = j + j // 2 + 1
    o_date = randint(g, ORDER_START, ORDER_END + 1, n_ord)
    n_lines = randint(g, 1, 8, n_ord)
    prio, prio_d = fixed(randint(g, 0, 5, n_ord), PRIORITIES)
    n_clerk = max(int(1000 * scale), 1000)
    clerk, clerk_d = encode(randint(g, 1, n_clerk + 1, n_ord),
                            _numbered("Clerk#", 9))
    o_com, o_com_d = _comment(g, n_ord, 4)

    g = s("lineitem")
    o_idx = torch.arange(n_ord, device=dev).repeat_interleave(n_lines)
    l_ok = ok[o_idx]
    n_li = l_ok.shape[0]
    first = torch.cumsum(n_lines, 0) - n_lines
    lineno = (torch.arange(n_li, device=dev)
              - first.repeat_interleave(n_lines) + 1).to(torch.int32)
    l_odate = o_date.repeat_interleave(n_lines)
    ship = l_odate + randint(g, 1, 122, n_li)
    commit = l_odate + randint(g, 30, 91, n_li)
    receipt = ship + randint(g, 1, 31, n_li)
    # returnflag: A=0, N=1, R=2; linestatus: F=0, O=1
    rf = torch.where(receipt <= CURRENT,
                     torch.where(rand(g, n_li) < 0.5, 2, 0), 1)
    ls = (ship > CURRENT).to(torch.int64)
    qty = randint(g, 1, 51, n_li)
    l_pk = randint(g, 1, n_part + 1, n_li)
    which = randint(g, 0, 4, n_li)
    l_sk = supplier_of(l_pk, which, n_supp)
    price = qty * retail_cents(l_pk)
    disc = _cents(g, 0, 10, n_li)
    tax = _cents(g, 0, 8, n_li)
    instr, instr_d = fixed(randint(g, 0, 4, n_li), INSTRUCTS)
    mode, mode_d = fixed(randint(g, 0, 7, n_li), SHIPMODES)
    l_com, l_com_d = _comment(g, n_li, 2)

    # an order is F when all its lines are, O when none is, else P
    n_f = torch.zeros(n_ord, dtype=torch.int64, device=dev)
    n_f.index_add_(0, o_idx, 1 - ls)
    status = torch.where(n_f == n_lines, 0, torch.where(n_f == 0, 1, 2))
    total = torch.zeros(n_ord, dtype=torch.int64, device=dev)
    # dbgen's total: each line's price less its discount, plus its tax,
    # in whole cents at each step
    total.index_add_(0, o_idx, (price * (100 - disc) // 100)
                     * (100 + tax) // 100)
    orders = Table([("o_orderkey", I64, 0), ("o_custkey", I64, 0),
                    ("o_orderstatus", STR, 0), ("o_totalprice", DEC, 2),
                    ("o_orderdate", DATE, 0), ("o_orderpriority", STR, 0),
                    ("o_clerk", STR, 0), ("o_shippriority", I32, 0),
                    ("o_comment", STR, 0)],
                   {"o_orderkey": ok, "o_custkey": o_cust,
                    "o_orderstatus": status.to(torch.int32),
                    "o_totalprice": total,
                    "o_orderdate": o_date.to(torch.int32),
                    "o_orderpriority": prio, "o_clerk": clerk,
                    "o_shippriority": torch.zeros(n_ord, dtype=torch.int32,
                                                  device=dev),
                    "o_comment": o_com},
                   {"o_orderstatus": ["F", "O", "P"],
                    "o_orderpriority": prio_d, "o_clerk": clerk_d,
                    "o_comment": o_com_d})
    lineitem = Table([("l_orderkey", I64, 0), ("l_partkey", I64, 0),
                      ("l_suppkey", I64, 0), ("l_linenumber", I32, 0),
                      ("l_quantity", DEC, 2), ("l_extendedprice", DEC, 2),
                      ("l_discount", DEC, 2), ("l_tax", DEC, 2),
                      ("l_returnflag", STR, 0), ("l_linestatus", STR, 0),
                      ("l_shipdate", DATE, 0), ("l_commitdate", DATE, 0),
                      ("l_receiptdate", DATE, 0), ("l_shipinstruct", STR, 0),
                      ("l_shipmode", STR, 0), ("l_comment", STR, 0)],
                     {"l_orderkey": l_ok, "l_partkey": l_pk,
                      "l_suppkey": l_sk, "l_linenumber": lineno,
                      "l_quantity": qty * 100, "l_extendedprice": price,
                      "l_discount": disc, "l_tax": tax,
                      "l_returnflag": rf.to(torch.int32),
                      "l_linestatus": ls.to(torch.int32),
                      "l_shipdate": ship.to(torch.int32),
                      "l_commitdate": commit.to(torch.int32),
                      "l_receiptdate": receipt.to(torch.int32),
                      "l_shipinstruct": instr, "l_shipmode": mode,
                      "l_comment": l_com},
                     {"l_returnflag": ["A", "N", "R"],
                      "l_linestatus": ["F", "O"],
                      "l_shipinstruct": instr_d, "l_shipmode": mode_d,
                      "l_comment": l_com_d})
    return {"orders": orders, "lineitem": lineitem}


def make(scale: float, seed: int, device, tables) -> dict[str, Table]:
    """The tables named in ``tables`` at ``scale`` (TPC-H's scale factor),
    made on ``device`` from ``seed``."""
    sz = sizes(scale)
    s = Streams(seed, device)
    dev = s.device
    out: dict[str, Table] = {}
    for group in dict.fromkeys(_GROUP[t] for t in tables):
        if group == "region":
            out["region"] = _region(s, dev)
        elif group == "nation":
            out["nation"] = _nation(s, dev)
        elif group == "supplier":
            out["supplier"] = _supplier(s, dev, sz["supplier"])
        elif group == "customer":
            out["customer"] = _customer(s, dev, sz["customer"])
        elif group == "part":
            out.update(_part(s, dev, sz["part"], sz["supplier"]))
        else:
            out.update(_orders(s, dev, sz, scale))
    return {t: out[t] for t in tables}

