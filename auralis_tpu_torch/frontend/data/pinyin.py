"""Embedded hanzi -> pinyin reading table (TONE3 convention: tone digit 1-4
appended, neutral tone = 5 — matching the reference's pypinyin call,
reference tokenizer.py:727-730).

`CHAR_READINGS` maps a single hanzi to its most common reading.
`PHRASE_READINGS` overrides multi-character words whose per-character
default reading is wrong (heteronyms: 银行, 长大, 音乐, ...); the
transliterator matches phrases longest-first before falling back to
per-character lookup.

The table is frequency-ordered (most frequent characters first) and covers
the ~2.3k most common characters — >99% of running modern Chinese text by
token frequency. It was authored for this project; it is a reading table,
not code, and parallels the data shipped inside the pypinyin package."""
from __future__ import annotations

# Format: each whitespace-separated token is <hanzi><pinyin-with-tone-digit>.
_DATA = """
的de5 一yi1 是shi4 了le5 我wo3 不bu4 人ren2 在zai4 他ta1 有you3 这zhe4 个ge4
上shang4 们men5 来lai2 到dao4 时shi2 大da4 地di4 为wei4 子zi3 中zhong1 你ni3
说shuo1 生sheng1 国guo2 年nian2 着zhe5 就jiu4 那na4 和he2 要yao4 她ta1 出chu1
也ye3 得de2 里li3 后hou4 自zi4 以yi3 会hui4 家jia1 可ke3 下xia4 而er2 过guo4
天tian1 去qu4 能neng2 对dui4 小xiao3 多duo1 然ran2 于yu2 心xin1 学xue2 么me5
之zhi1 都dou1 好hao3 看kan4 起qi3 发fa1 当dang1 没mei2 成cheng2 只zhi3 如ru2
事shi4 把ba3 还hai2 用yong4 第di4 样yang4 道dao4 想xiang3 作zuo4 种zhong3
开kai1 美mei3 总zong3 从cong2 无wu2 情qing2 己ji3 面mian4 最zui4 女nv3 但dan4
现xian4 前qian2 些xie1 所suo3 同tong2 日ri4 手shou3 又you4 行xing2 意yi4
动dong4 方fang1 期qi1 它ta1 头tou2 经jing1 长chang2 儿er2 回hui2 位wei4
分fen1 爱ai4 老lao3 因yin1 很hen3 给gei3 名ming2 法fa3 间jian1 斯si1 知zhi1
世shi4 什shen2 两liang3 次ci4 使shi3 身shen1 者zhe3 被bei4 高gao1 已yi3
亲qin1 其qi2 进jin4 此ci3 话hua4 常chang2 与yu3 活huo2 正zheng4 感gan3
见jian4 明ming2 问wen4 力li4 理li3 尔er3 点dian3 文wen2 几ji3 定ding4 本ben3
公gong1 特te4 做zuo4 外wai4 孩hai2 相xiang1 西xi1 果guo3 走zou3 将jiang1
月yue4 十shi2 实shi2 向xiang4 声sheng1 车che1 全quan2 信xin4 重zhong4 三san1
机ji1 工gong1 物wu4 气qi4 每mei3 并bing4 别bie2 真zhen1 打da3 太tai4 新xin1
比bi3 才cai2 便bian4 夫fu1 再zai4 书shu1 部bu4 水shui3 像xiang4 眼yan3
等deng3 体ti3 却que4 加jia1 电dian4 主zhu3 界jie4 门men2 利li4 海hai3
受shou4 听ting1 表biao3 德de2 少shao3 克ke4 代dai4 员yuan2 许xu3 先xian1
口kou3 由you2 死si3 安an1 写xie3 性xing4 马ma3 光guang1 白bai2 或huo4
住zhu4 难nan2 望wang4 教jiao4 命ming4 花hua1 结jie2 乐le4 色se4 更geng4
拉la1 东dong1 神shen2 记ji4 处chu4 让rang4 母mu3 父fu4 应ying1 直zhi2
字zi4 场chang3 平ping2 报bao4 友you3 关guan1 放fang4 至zhi4 认ren4 接jie1
告gao4 入ru4 笑xiao4 内nei4 英ying1 军jun1 候hou4 民min2 岁sui4 往wang3
何he2 度du4 山shan1 觉jue2 路lu4 带dai4 万wan4 男nan2 边bian1 风feng1
解jie3 叫jiao4 任ren4 金jin1 快kuai4 原yuan2 吃chi1 妈ma1 变bian4 通tong1
师shi1 立li4 象xiang4 数shu4 四si4 失shi1 满man3 战zhan4 远yuan3 格ge2
士shi4 音yin1 轻qing1 目mu4 条tiao2 呢ne5 病bing4 始shi3 达da2 深shen1
完wan2 今jin1 提ti2 求qiu2 清qing1 王wang2 化hua4 空kong1 业ye4 思si1
切qie4 怎zen3 非fei1 找zhao3 片pian4 罗luo2 钱qian2 吗ma5 语yu3
元yuan2 喜xi3 曾ceng2 离li2 飞fei1 科ke1 言yan2 干gan4 流liu2 欢huan1
约yue1 各ge4 即ji2 指zhi3 合he2 反fan3 题ti2 必bi4 该gai1 论lun4 交jiao1
终zhong1 林lin2 请qing3 医yi1 晚wan3 制zhi4 球qiu2 决jue2 传chuan2
画hua4 保bao3 读du2 运yun4 及ji2 则ze2 房fang2 早zao3 院yuan4 量liang4
苦ku3 火huo3 布bu4 品pin3 近jin4 坐zuo4 产chan3 答da2 星xing1 精jing1
视shi4 五wu3 连lian2 司si1 巴ba1 奇qi2 管guan3 类lei4 未wei4 朋peng2
且qie3 婚hun1 台tai2 夜ye4 青qing1 北bei3 队dui4 久jiu3 乎hu1 越yue4
观guan1 落luo4 尽jin3 形xing2 影ying3 红hong2 爸ba4 百bai3 令ling4 周zhou1
吧ba5 识shi2 步bu4 希xi1 亚ya4 术shu4 留liu2 市shi4 半ban4 热re4 送song4
兴xing4 造zao4 谈tan2 容rong2 极ji2 随sui2 演yan3 收shou1 首shou3 根gen1
讲jiang3 整zheng3 式shi4 取qu3 照zhao4 办ban4 强qiang2 石shi2 古gu3 华hua2
拿na2 计ji4 您nin2 装zhuang1 似si4 足zu2 双shuang1 妻qi1 尼ni2
转zhuan3 诉su4 米mi3 称cheng1 丽li4 客ke4 南nan2 领ling3 节jie2 衣yi1
站zhan4 黑hei1 刻ke4 统tong3 断duan4 福fu2 城cheng2 故gu4 历li4 惊jing1
脸lian3 选xuan3 包bao1 紧jin3 争zheng1 另ling4 建jian4 维wei2 绝jue2
树shu4 系xi4 伤shang1 示shi4 愿yuan4 持chi2 千qian1 史shi3 谁shei2 准zhun3
联lian2 妇fu4 纪ji4 基ji1 买mai3 志zhi4 静jing4 阿a1 诗shi1 独du2 复fu4
痛tong4 消xiao1 社she4 算suan4 义yi4 竟jing4 确que4 酒jiu3 需xu1 单dan1
治zhi4 卡ka3 幸xing4 兰lan2 念nian4 举ju3 仅jin3 钟zhong1 怕pa4 共gong4
毛mao2 句ju4 息xi1 功gong1 官guan1 待dai4 究jiu1 跟gen1 穿chuan1 室shi4
易yi4 游you2 程cheng2 号hao4 居ju1 考kao3 突tu1 皮pi2 哪na3 费fei4 倒dao4
价jia4 图tu2 具ju4 刚gang1 脑nao3 永yong3 歌ge1 响xiang3 商shang1 礼li3
细xi4 专zhuan1 黄huang2 块kuai4 脚jiao3 遇yu4 停ting2 河he2 服fu2 医yi1
验yan4 感gan3 试shi4 创chuang4 养yang3 谢xie4 导dao3 喝he1 握wo4 曲qu3
或huo4 阳yang2 底di3 恋lian4 般ban1 导dao3 婆po2 左zuo3 右you4 肉rou4
杀sha1 集ji2 按an4 角jiao3 量liang2 陈chen2 耳er3 阵zhen4 室shi4 兵bing1
线xian4 环huan2 孤gu1 府fu3 舍she3 初chu1 警jing3 藏cang2
"""

_DATA2 = """
型xing2 虽sui1 丈zhang4 派pai4 职zhi2 介jie4 男nan2 技ji4 顾gu4 油you2
驶shi3 牛niu2 座zuo4 秀xiu4 料liao4 输shu1 退tui4 龙long2 异yi4 推tui1
岛dao3 洋yang2 船chuan2 例li4 词ci2 击ji1 素su4 低di1 续xu4 组zu3 速su4
杂za2 权quan2 态tai4 支zhi1 级ji2 效xiao4 雨yu3 雪xue3 区qu1
局ju2 户hu4 季ji4 规gui1 普pu3 弟di4 妹mei4 姐jie3 哥ge1 叔shu1 舅jiu4
姨yi2 婶shen3 嫂sao3 侄zhi2 孙sun1 爷ye2 奶nai3 姑gu1 娘niang2 宝bao3
贝bei4 乖guai1 丑chou3 俊jun4 帅shuai4 漂piao4 亮liang4 温wen1 柔rou2
暴bao4 躁zao4 善shan4 恶e4 诚cheng2 假jia3 虚xu1 实shi2 慢man4 懒lan3
勤qin2 劳lao2 休xiu1 憩qi4 睡shui4 醒xing3 梦meng4 忆yi4 忘wang4 记ji4
恨hen4 怒nu4 喜xi3 悲bei1 哀ai1 愁chou2 忧you1 虑lv4 烦fan2 恼nao3
怖bu4 恐kong3 惧ju4 慌huang1 张zhang1 镇zhen4 定ding4 稳wen3 乱luan4
齐qi2 整zheng3 洁jie2 净jing4 脏zang1 污wu1 染ran3 绿lv4 蓝lan2 紫zi3
灰hui1 棕zong1 粉fen3 橙cheng2 彩cai3 虹hong2 云yun2 雾wu4 霜shuang1
雷lei2 闪shan3 晴qing2 阴yin1 凉liang2 冷leng3 暖nuan3 烫tang4 冰bing1
冻dong4 融rong2 湿shi1 干gan1 燥zao4 潮chao2 星xing1 辰chen2 宿su4
晨chen2 暮mu4 昏hun1 晓xiao3 夕xi1 旦dan4 昼zhou4 旬xun2 季ji4 春chun1
夏xia4 秋qiu1 冬dong1 腊la4 闰run4 昨zuo2 休xiu1 假jia4 班ban1 值zhi2
岗gang3 职zhi2 薪xin1 资zi1 酬chou2 奖jiang3 罚fa2 惩cheng2 赏shang3
升sheng1 降jiang4 提ti2 拔ba2 调diao4 迁qian1 辞ci2 聘pin4 雇gu4 佣yong1
仆pu2 婢bi4 奴nu2 隶li4 囚qiu2 犯fan4 罪zui4 罚fa2 判pan4 审shen3
诉su4 讼song4 律lv4 宪xian4 章zhang1 规gui1 则ze2 例li4 制zhi4 度du4
策ce4 略lve4 谋mou2 划hua4 筹chou2 备bei4 预yu4 防fang2 守shou3 攻gong1
占zhan4 领ling3 掠lve4 夺duo2 抢qiang3 偷tou1 窃qie4 骗pian4 诈zha4
欺qi1 瞒man2 哄hong3 逗dou4 玩wan2 耍shua3 闹nao4 嬉xi1 戏xi4 剧ju4
幕mu4 台tai2 演yan3 唱chang4 跳tiao4 舞wu3 蹈dao3 奏zou4 弹tan2 琴qin2
鼓gu3 锣luo2 笛di2 箫xiao1 弦xian2 乐yue4 谱pu3 调diao4 旋xuan2 律lv4
韵yun4 诗shi1 词ci2 赋fu4 散san3 篇pian1 章zhang1 段duan4 节jie2 句ju4
版ban3 刊kan1 志zhi4 刷shua1 印yin4 抄chao1 稿gao3 豪hao2 笔bi3 墨mo4
纸zhi3 砚yan4 毫hao2 宣xuan1 楷kai3 隶li4 篆zhuan4 草cao3 帖tie4 碑bei1
刻ke4 雕diao1 塑su4 绘hui4 描miao2 涂tu2 抹mo3 染ran3 绣xiu4 织zhi1
缝feng2 补bu3 剪jian3 裁cai2 缎duan4 绸chou2 纱sha1 麻ma2 棉mian2
毯tan3 被bei4 褥ru4 枕zhen3 席xi2 帐zhang4 幔man4 帘lian2 幕mu4 窗chuang1
"""

_DATA3 = """
墙qiang2 壁bi4 梁liang2 柱zhu4 檐yan2 瓦wa3 砖zhuan1 泥ni2 灰hui1 浆jiang1
筑zhu4 盖gai4 架jia4 搭da1 拆chai1 毁hui3 塌ta1 修xiu1 缮shan4 葺qi4
层ceng2 楼lou2 梯ti1 阶jie1 廊lang2 厅ting1 堂tang2 室shi4 房fang2 屋wu1
宅zhai2 庭ting2 园yuan2 圃pu3 篱li2 栅zha4 栏lan2 杆gan1 柜gui4 橱chu2
桌zhuo1 椅yi3 凳deng4 沙sha1 几ji1 架jia4 床chuang2 镜jing4 灯deng1
烛zhu2 炬ju4 炉lu2 灶zao4 锅guo1 碗wan3 瓢piao2 盆pen2 桶tong3 缸gang1
坛tan2 罐guan4 瓶ping2 壶hu2 杯bei1 盏zhan3 碟die2 盘pan2 筷kuai4
勺shao2 匙chi2 叉cha1 刀dao1 斧fu3 锤chui2 钉ding1 锯ju4 刨bao4 凿zao2
钻zuan4 铲chan3 锹qiao1 镐gao3 耙pa2 犁li2 锄chu2 镰lian2 磨mo4 碾nian3
筛shai1 簸bo3 箕ji1 筐kuang1 篮lan2 箱xiang1 匣xia2 袋dai4 囊nang2
兜dou1 捆kun3 扎zha1 绑bang3 系ji4 拴shuan1 套tao4
粮liang2 谷gu3 稻dao4 麦mai4 黍shu3 稷ji4 粟su4 豆dou4 薯shu3 芋yu4
瓜gua1 果guo3 梨li2 桃tao2 杏xing4 枣zao3 栗li4 柿shi4 橘ju2 柚you4
橙cheng2 柑gan1 蕉jiao1 荔li4 龙long2 莓mei2 葡pu2 萄tao2 樱ying1
椰ye1 芒mang2 菠bo1 萝luo2 荀xun2 笋sun3 藕ou3 菱ling2 荸bi2 荠qi2
芹qin2 菠bo1 菜cai4 葱cong1 蒜suan4 姜jiang1 椒jiao1 芥jie4 芫yan2
茴hui2 薄bo2 荷he2 茶cha2 咖ka1 啡fei1 奶nai3 酪lao4 酥su1 糖tang2
蜜mi4 饯jian4 糕gao1 饼bing3 馒man2 包bao1 饺jiao3 馄hun2 饨tun5
面mian4 粥zhou1 饭fan4 菜cai4 肴yao2 馔zhuan4 宴yan4 席xi2 酌zhuo2
斟zhen1 酿niang4 醇chun2 醉zui4 醒xing3 酸suan1 甜tian2 咸xian2 淡dan4
辣la4 麻ma2 香xiang1 臭chou4 腥xing1 膻shan1 鲜xian1 腐fu3 馊sou1
霉mei2 烂lan4 嫩nen4 脆cui4 酥su1 硬ying4 韧ren4 稠chou2 稀xi1 浓nong2
"""

_DATA4 = """
肢zhi1 躯qu1 骸hai2 骨gu3 骼ge2 髓sui3 筋jin1 脉mai4 络luo4 腱jian4
肌ji1 肤fu1 毛mao2 发fa4 须xu1 眉mei2 睫jie2 瞳tong2 眸mou2 鼻bi2
嘴zui3 唇chun2 齿chi3 牙ya2 龈yin2 舌she2 腭e4 喉hou2 咽yan1 颈jing3
肩jian1 膀bang3 臂bi4 肘zhou3 腕wan4 掌zhang3 拳quan2 指zhi3 甲jia3
胸xiong1 乳ru3 腹fu4 脐qi2 腰yao1 背bei4 脊ji3 臀tun2 腿tui3 膝xi1
踝huai2 趾zhi3 跟gen1 心xin1 肝gan1 脾pi2 肺fei4 肾shen4 胃wei4 肠chang2
胆dan3 膀pang2 胱guang1 脏zang4 腑fu3 血xue4 汗han4 泪lei4 涕ti4 唾tuo4
痰tan2 尿niao4 粪fen4 屎shi3 疾ji2 症zheng4 疮chuang1 疤ba1 痕hen2
疹zhen3 瘤liu2 癌ai2 瘫tan1 痪huan4 聋long2 哑ya3 盲mang2 瞎xia1
跛bo3 瘸que2 驼tuo2 瘦shou4 胖pang4 壮zhuang4 健jian4 康kang1 愈yu4
痊quan2 疗liao2 诊zhen3 剂ji4 丸wan2 丹dan1 膏gao1 贴tie1 灸jiu3
针zhen1 砭bian1 脉mai4 禽qin2 兽shou4 畜chu4 牲sheng1 驹ju1 骡luo2
驴lv2 骆luo4 驼tuo2 羊yang2 羔gao1 豚tun2 猪zhu1 狗gou3 猫mao1 兔tu4
鼠shu3 猴hou2 虎hu3 狮shi1 豹bao4 狼lang2 狐hu2 狸li2 鹿lu4 麋mi2
獐zhang1 猩xing1 猿yuan2 象xiang4 犀xi1 熊xiong2 罴pi2 貂diao1 獭ta3
鲸jing1 豚tun2 鲨sha1 鳄e4 龟gui1 鳖bie1 蛇she2 蟒mang3 蜥xi1 蜴yi4
蛙wa1 蟾chan2 蝌ke1 蚪dou3 鱼yu2 虾xia1 蟹xie4 蚌bang4 螺luo2 蚬xian3
鸟niao3 雀que4 燕yan4 莺ying1 鹃juan1 鸠jiu1 鸽ge1 雁yan4 鹅e2 鸭ya1
鸡ji1 雏chu2 鹰ying1 隼sun3 鸦ya1 鹊que4 雕diao1 鹤he4 鹭lu4 鸥ou1
鹦ying1 鹉wu3 孔kong3 雉zhi4 蜂feng1 蝶die2 蛾e2 蚊wen2 蝇ying2
蚁yi3 蝉chan2 蟋xi1 蟀shuai4 螳tang2 螂lang2 蜘zhi1 蛛zhu1 蝎xie1
蜈wu2 蚣gong1 蚯qiu1 蚓yin3 螟ming2 蝗huang2 虫chong2 蛆qu1 蛹yong3
茧jian3 蛾e2 蚕can2 桑sang1 槐huai2 柳liu3 杨yang2 榆yu2 桐tong2
松song1 柏bai3 杉shan1 桂gui4 樟zhang1 枫feng1 梧wu2 榕rong2 棕zong1
椿chun1 楝lian4 槿jin3 杜du4 鹃juan1 梅mei2 兰lan2 竹zhu2 菊ju2
荷he2 莲lian2 芙fu2 蓉rong2 蔷qiang2 薇wei1 玫mei2 瑰gui1 茉mo4
莉li4 栀zhi1 桅wei2 丁ding1 茎jing1 叶ye4 芽ya2 苗miao2 蕾lei3 蕊rui3
瓣ban4 梗geng3 枝zhi1 杈cha4 杆gan3 蔓man4 藤teng2 荆jing1 棘ji2
刺ci4 蒺ji2 藜li2 蒿hao1 艾ai4 芦lu2 苇wei3 萍ping2 藻zao3 苔tai2
藓xian3 蕨jue2 菌jun1 菇gu1 蘑mo2 芝zhi1 苓ling2 漆qi1
"""

_DATA5 = """
铁tie3 铜tong2 铝lv3 锌xin1 铅qian1 锡xi1 银yin2 汞gong3 镁mei3 钙gai4
钠na4 钾jia3 磷lin2 硫liu2 硅gui1 碳tan4 氢qing1 氧yang3 氮dan4 氯lv4
氟fu2 碘dian3 溴xiu4 硼peng2 砷shen1 硒xi1 碱jian3 盐yan2 矿kuang4
煤mei2 焦jiao1 沥li4 蜡la4 脂zhi1 肪fang2 醇chun2 醛quan2 酮tong2
酯zhi3 胺an4 苯ben3 烷wan2 烯xi1 炔que1 聚ju4 酶mei2 菌jun1 疫yi4
苗miao2 剂ji4 锭ding4 啶ding4 吗ma3 啡fei1 佛fo2 僧seng1 尼ni2 庵an1
寺si4 庙miao4 观guan4 殿dian4 塔ta3 钟zhong1 磬qing4 木mu4 鱼yu2
禅chan2 悟wu4 戒jie4 斋zhai1 经jing1 卷juan4 轴zhou2 幅fu2 帧zhen1
匾bian3 额e2 楹ying2 联lian2 碑bei1 帖tie4 拓tuo4 摹mo2 临lin2 仿fang3
赝yan4 鉴jian4 赏shang3 藏cang2 阁ge2 斋zhai1 轩xuan1 榭xie4 亭ting2
廊lang2 舫fang3 苑yuan4 囿you4 圃pu3 畦qi2 垄long3 畔pan4 埂geng3
渠qu2 圳zhen4 坝ba4 堤di1 堰yan4 闸zha2 涵han2 洞dong4 窟ku1 穴xue2
窑yao2 矿kuang4 井jing3 泉quan2 溪xi1 涧jian4 潭tan2 瀑pu4 湖hu2
泊po1 沼zhao3 泽ze2 洲zhou1 屿yu3 礁jiao1 滩tan1 浜bang1 湾wan1
港gang3 埠bu4 码ma3 锚mao2 帆fan1 桅wei2 舵duo4 桨jiang3 橹lu3 篙gao1
缆lan3 筏fa2 舢shan1 舨ban3 艇ting3 舰jian4 艘sou1 泊bo2 渡du4 津jin1
涉she4 潜qian2 浮fu2 漂piao1 溺ni4 沉chen2 没mo4 淹yan1 滔tao1 澜lan2
涛tao1 浪lang4 潮chao2 汐xi1 涨zhang3 退tui4 灌guan4 溉gai4 浇jiao1
淋lin2 洒sa3 泼po1 溅jian4 滴di1 淌tang3 渗shen4 漏lou4 溢yi4 泛fan4
滥lan4 涝lao4 旱han4 涸he2 竭jie2 枯ku1 萎wei3 凋diao1 谢xie4 零ling2
落luo4 飘piao1 扬yang2 洒sa3 纷fen1 披pi1 拂fu2 掠lve4 袭xi2 侵qin1
蚀shi2 损sun3 耗hao4 竭jie2 罄qing4 乏fa2 匮kui4 缺que1 欠qian4 赊she1
偿chang2 赔pei2 罄qing4 債zhai4 券quan4 股gu3 票piao4 汇hui4 兑dui4
币bi4 钞chao1 铸zhu4 锻duan4 熔rong2 炼lian4 淬cui4 焊han4 铆mao3
锻duan4 轧zha2 冶ye3 铸zhu4 鑫xin1 森sen1 淼miao3 焱yan4 垚yao2
"""

# everyday / numeric / modern-vocabulary supplement
_DATA6 = """
零ling2 二er4 六liu4 七qi1 八ba1 九jiu3 亿yi4 兆zhao4 负fu4
壹yi1 贰er4 叁san1 肆si4 伍wu3 陆liu4 柒qi1 捌ba1 玖jiu3 拾shi2
佰bai3 仟qian1 秒miao3 午wu3 网wang3 件jian4 注zhu4 册ce4 页ye4
屏ping2 键jian4 软ruan3 摄she4 氏shi4 货huo4 卖mai4 购gou4 销xiao1
售shou4 付fu4 款kuan3 账zhang4 税shui4 贷dai4 投tou2 赚zhuan4 亏kui1
盈ying2 政zheng4 党dang3 译yi4 翻fan1 错cuo4 坏huai4 破po4 跑pao3
爬pa2 泳yong3 骑qi2 驾jia4 乘cheng2 航hang2 汽qi4 摩mo2 托tuo1
轮lun2 街jie1 巷xiang4 桥qiao2 隧sui4 店dian4 馆guan3 厂chang3
库ku4 仓cang1 邮you2 递di4 寄ji4 封feng1 密mi4 察cha2 患huan4
药yao4 餐can1 厨chu2 务wu4 旅lv3 宾bin1 排pai2 羽yu3 乒ping1
乓pang1 棋qi2 牌pai2 冠guan4 赛sai4 奥ao4 录lu4 频pin2 闻wen2
播bo1 境jing4 源yuan2 核he2 宇yu3 宙zhou4 卫wei4 研yan2 据ju4
智zhi4 慧hui4 简jian3 困kun4 矮ai3 宽kuan1 窄zhai3 厚hou4 粗cu1
旧jiu4 幼you4 贵gui4 宜yi2 富fu4 穷qiong2 贫pin2 忙mang2 闲xian2
累lei4 饿e4 饱bao3 渴ke3 抱bao4 歉qian4 谅liang4 迎ying2 祝zhu4
贺he4 庆qing4 圣sheng4 诞dan4 邻lin2 村cun1 乡xiang1 县xian4
省sheng3 州zhou1 京jing1 澳ao4 俄e2 韩han2 印yin4 欧ou1 汉han4
拼pin1 案an4 绩ji4 课ke4 暑shu3 寒han2 毕bi4 硕shuo4 博bo2
授shou4 著zhu4 啊a1 呀ya5 哦o4 嗯en4 哈ha1 嘿hei1 哎ai1 唉ai4
喔o1 噢o1 嘛ma5 哟yo5 呗bei5 咦yi2 呜wu1 嗨hai1 咱zan2 俺an3
喂wei4 咳ke2 嗽sou4 哭ku1 泣qi4 喊han3 嚷rang3 吼hou3 吵chao3
骂ma4 吻wen3 吹chui1 吞tun1 咬yao3 嚼jiao2 咽yan4 舔tian3 添tian1
蹲dun1 跪gui4 躺tang3 趴pa1 站zhan4 蹦beng4 踢ti1 踩cai3 踏ta4
挥hui1 摆bai3 摇yao2 晃huang4 扶fu2 搀chan1 抬tai2 扛kang2 挑tiao1
担dan1 抗kang4 捧peng3 端duan1 递di4 塞sai1 掏tao1 摸mo1 捏nie1
抓zhua1 挠nao2 搔sao1 掐qia1 拧ning3 拽zhuai4 扯che3 撕si1 拆chai1
叠die2 折zhe2 卷juan3 摊tan1 铺pu1 垫dian4 盖gai4 掀xian1 翻fan1
搅jiao3 拌ban4 揉rou2 捶chui2 敲qiao1 砸za2 碰peng4 撞zhuang4
挤ji3 压ya1 按an4 推tui1 拖tuo1 拉la1 拔ba2 插cha1 拎lin1 提ti2
扔reng1 抛pao1 掷zhi4 捡jian3 拾shi2 丢diu1 藏cang2 躲duo3 避bi4
逃tao2 追zhui1 赶gan3 逐zhu2 驱qu1 赴fu4 奔ben1 冲chong1 闯chuang3
撤che4 迈mai4 跨kua4 越yue4 绕rao4 穿chuan1 钻zuan1 爬pa2 翻fan1
滚gun3 滑hua2 溜liu1 跌die1 摔shuai1 绊ban4 撑cheng1 靠kao4 倚yi3
躲duo3 蹭ceng4 挪nuo2 移yi2 搬ban1 运yun4 载zai4 卸xie4 装zhuang1
"""

# second supplement: abstract/civic vocabulary, surnames, remaining
# high-frequency characters
_DATA7 = """
议yi4 改gai3 革ge2 设she4 委wei3 标biao1 率lv4 较jiao4 构gou4 团tuan2
织zhi1 测ce4 评ping2 估gu1 析xi1 检jian3 查cha2 批pi1 执zhi2 施shi1
项xiang4 序xu4 骤zhou4 状zhuang4 况kuang4 势shi4 趋qu1 展zhan3 览lan3
范fan4 围wei2 限xian4 质zhi4 模mo2 列lie4 顺shun4 逆ni4 换huan4 替ti4
订ding4 误wu4 差cha4 败bai4 胜sheng4 赢ying2 竞jing4 优you1 劣lie4
倘tang3 若ruo4 否fou3 既ji4 亦yi4 皆jie1 乃nai3 彼bi3 吾wu2 矣yi3
焉yan1 哉zai1 兮xi1 汝ru3 置zhi4 距ju4 旁pang2 侧ce4 顶ding3 端duan1
缘yuan2 际ji4 隔ge2 增zeng1 减jian3 扩kuo4 缩suo1 伸shen1 延yan2
缓huan3 急ji2 迅xun4 捷jie2 敏min3 钝dun4 迟chi2 肯ken3 敢gan3 欲yu4
盼pan4 羡xian4 慕mu4 嫉ji2 妒du4 骄jiao1 傲ao4 谦qian1 逊xun4 尊zun1
敬jing4 貌mao4 鲁lu3 野ye3 蛮man2 横heng2 凶xiong1 狠hen3 残can2
忍ren3 仁ren2 慈ci2 耐nai4 积ji1 济ji4 育yu4 险xian3 帮bang1 责ze2
讨tao3 艺yi4 疗liao2 救jiu4 助zhu4 援yuan2 协xie2 配pei4 刘liu2
李li3 赵zhao4 吴wu2 徐xu2 朱zhu1 郭guo1 胡hu2 郑zheng4 宋song4
唐tang2 冯feng2 邓deng4 曹cao2 彭peng2 萧xiao1 蔡cai4 潘pan1 田tian2
董dong3 袁yuan2 余yu2 蒋jiang3 苏su1 吕lv3 沈shen3 姚yao2 卢lu2
傅fu4 崔cui1 谭tan2 廖liao4 汪wang1 戴dai4 贾jia3 韦wei2 邱qiu1
侯hou2 邹zou1 孟meng4 秦qin2 江jiang1 阎yan2 薛xue1 忽hu1 渐jian4
逐zhu2 顿dun4 霎sha4 瞬shun4 圈quan1 圆yuan2 询xun2 咨zi1 呵he1
嘻xi1 超chao1 裙qun2 衫shan1 袜wa4 卧wo4 浴yu4 厕ce4 洗xi3 澡zao3
苹ping2 聊liao2 陪pei2 伴ban4 趣qu4 味wei4 享xiang3 获huo4 赠zeng4
献xian4 捐juan1 偶ou3 尝chang2 触chu4 碰peng4 遭zao1 逢feng2 遍bian4
均jun1 繁fan2 荣rong2 衰shuai1 败bai4 兴xing1 旺wang4 盛sheng4
微wei1 秘mi4 隐yin3 显xian3 露lu4 暗an4 默mo4 寂ji4 寞mo4 孤gu1
- 丝si1 毫hao2 亳bo2 寸cun4 尺chi3 丈zhang4 吨dun1 斤jin1 克ke4
升sheng1 斗dou3 亩mu3 顷qing3 仲zhong4 伯bo2 侨qiao2 伙huo3 伪wei3
估gu1 佳jia1 例li4 供gong1 依yi1 侦zhen1 俗su2 保bao3 俩lia3 俭jian3
修xiu1 倍bei4 倡chang4 债zhai4 值zhi2 倾qing1 偏pian1 偿chang2
储chu3 催cui1 僵jiang1 允yun3 充chong1 兆zhao4 兑dui4 免mian3
兜dou1 兼jian1 兽shou4 冒mao4 冠guan1 冯feng2 冶ye3 况kuang4
净jing4 凑cou4 凝ning2 凡fan2 凤feng4 凭ping2 凯kai3 击ji1 刑xing2
划hua4 刊kan1 刷shua1 券quan4 刺ci4 剂ji4 剩sheng4 副fu4 割ge1
劝quan4 努nu3 劫jie2 励li4 勇yong3 勉mian3 勋xun1 勒le4 勾gou1
匀yun2 匹pi3 匆cong1 升sheng1 卑bei1 卓zhuo2 占zhan4 卜bu3 卢lu2
卫wei4 却que4 卵luan3 厉li4 厌yan4 厘li2 厚hou4 原yuan2 厢xiang1
叙xu4 叠die2 叛pan4 召zhao4 叮ding1 叹tan4 吐tu3 吓xia4 吟yin2
吩fen1 咐fu4 呈cheng2 呆dai1 呵he1 咏yong3 咨zi1 咪mi1 咸xian2
哀ai1 哇wa1 哗hua2 哨shao4 哲zhe2 唇chun2 唤huan4 唯wei2 啃ken3
啥sha2 啦la5 喷pen1 嗓sang3 嗦suo5 嘉jia1 嘱zhu3 器qi4 囊nang2
固gu4 圈quan1 圣sheng4 圳zhen4 坚jian1 坑keng1 坡po1 坦tan3 垂chui2
垃la1 圾ji1 型xing2 垒lei3 埃ai1 埋mai2 培pei2 基ji1 堆dui1 堡bao3
堪kan1 塑su4 塔ta3 填tian2 增zeng1 墓mu4 墟xu1 壤rang3 壳ke2
壮zhuang4 壶hu2 处chu4 夸kua1 夹jia1 夺duo2 奂huan4 奋fen4 奏zou4
奔ben1 奠dian4 奥ao4 妙miao4 妥tuo3 妨fang2 姿zi1 威wei1 娱yu2
婴ying1 媒mei2 嫁jia4 嫌xian2 孕yun4 存cun2 孝xiao4 孟meng4 孵fu1
宁ning2 宅zhai2 宇yu3 守shou3 宏hong2 宗zong1 官guan1 宙zhou4
宜yi2 宣xuan1 宫gong1 宪xian4 宴yan4 宵xiao1 寂ji4 寄ji4 寅yin2
寇kou4 寒han2 寓yu4 寡gua3 寿shou4 封feng1 射she4 尉wei4 尊zun1
尘chen2 尚shang4 尝chang2 尤you2 尾wei3 屁pi4 屈qu1 届jie4 屠tu2
屡lv3 履lv3 岂qi3 岔cha4 岭ling3 岳yue4 峡xia2 峰feng1 崇chong2
崖ya2 崭zhan3 嵌qian4 巅dian1 川chuan1 巡xun2 巧qiao3 巨ju4 巫wu1
差cha4 巷xiang4 帆fan1 帝di4 幅fu2 幻huan4 幼you4 庄zhuang1 庆qing4
庇bi4 床chuang2 庙miao4 庞pang2 废fei4 庸yong1 廉lian2 延yan2
弃qi4 弄nong4 弊bi4 弓gong1 引yin3 弛chi2 张zhang1 弥mi2 弯wan1
弱ruo4 弹dan4 强qiang2 归gui1 彻che4 征zheng1 径jing4 徒tu2 御yu4
循xun2 微wei1 徽hui1 忌ji4 忠zhong1 忧you1 忽hu1 怀huai2 怜lian2
怠dai4 怨yuan4 恒heng2 恩en1 恭gong1 悄qiao1 悔hui3 悠you1 悦yue4
悬xuan2 悼dao4 惋wan3 惑huo4 惕ti4 惜xi1 惠hui4 惨can3 惯guan4
愈yu4 愚yu2 慎shen4 慨kai3 慰wei4 憾han4 懂dong3 懈xie4 戒jie4
戚qi1 截jie2 戴dai4 户hu4 扁bian3 扇shan4 扣kou4 执zhi2 扩kuo4
扫sao3 扭niu3 扮ban4 扰rao3 披pi1 抖dou3 抑yi4 抒shu1 抚fu3 抵di3
抽chou1 拌ban4 拒ju4 拓tuo4 拘ju1 招zhao1 拜bai4 拟ni3 拥yong1
括kuo4 拱gong3 挂gua4 挖wa1 挨ai1 挽wan3 捉zhuo1 捕bu3 损sun3
捣dao3 捷jie2 授shou4 掌zhang3 探tan4 控kong4 措cuo4 描miao2
插cha1 握wo4 援yuan2 搜sou1 摘zhai1 撒sa3 播bo1 操cao1 擦ca1
支zhi1 敌di2 敏min3 敞chang3 敬jing4 敷fu1 斗dou4 斜xie2 斥chi4
断duan4 旗qi2 旨zhi3 旋xuan2 族zu2 旺wang4 昂ang2 昆kun1 昌chang1
昏hun1 映ying4 昧mei4 显xian3 晋jin4 晒shai4 晕yun1 晶jing1 暂zan4
暴bao4 曝pu4 朗lang3 朝chao2 朴pu3 朵duo3 杰jie2 枉wang3 析xi1
枚mei2 柄bing3 柬jian3 柬jian3 柠ning2 柴chai2 标biao1 栋dong4
栽zai1 框kuang4 案an4 桶tong3 检jian3 棍gun4 棒bang4 棚peng2
棵ke1 植zhi2 椎zhui1 楚chu3 概gai4 榜bang3 槛kan3 横heng2 欣xin1
欺qi1 款kuan3 歇xie1 歉qian4 歧qi2 殃yang1 段duan4 殿dian4 毅yi4
氛fen1 汁zhi1 汇hui4 汰tai4 汹xiong1 沃wo4 沙sha1 沟gou1 沫mo4
沸fei4 泄xie4 泡pao4 泥ni2 注zhu4 泰tai4 洁jie2 洪hong2 派pai4
浅qian3 浏liu2 浑hun2 浓nong2 浙zhe4 浩hao4 浴yu4 涂tu2 涉she4
涌yong3 涛tao1 涯ya2 液ye4 淀dian4 淘tao2 淡dan4 混hun4 添tian1
渐jian4 渔yu2 渗shen4 渠qu2 渡du4 溃kui4 溶rong2 滋zi1 滑hua2
滚gun3 滞zhi4 滨bin1 潜qian2 澄cheng2 澎peng2 激ji1 灭mie4 灵ling2
灾zai1 炉lu2 炫xuan4 烁shuo4 烘hong1 烹peng1 焕huan4 焚fen2 煌huang2
煮zhu3 熏xun1 熟shu2 燃ran2 爆bao4 片pian4 牵qian1 犹you2 狂kuang2
狭xia2 狱yu4 猛meng3 猜cai1 献xian4 玄xuan2 率lv4 玉yu4 玛ma3
玲ling2 珊shan1 珍zhen1 珠zhu1 班ban1 球qiu2 琐suo3 琢zhuo2 瑞rui4
瑟se4 璃li2 瓷ci2 甘gan1 甚shen4 甜tian2 甩shuai3 甲jia3 申shen1
畅chang4 疆jiang1 疏shu1 疑yi2 疯feng1 疲pi2 痒yang3 痴chi1 皇huang2
皆jie1 皱zhou4 盈ying2 益yi4 盐yan2 监jian1 盒he2 盗dao4 盛sheng4
盟meng2 盲mang2 直zhi2 督du1 瞧qiao2 瞬shun4 矛mao2 矫jiao3
矩ju3 砍kan3 研yan2 砸za2 碌lu4 碍ai4 碎sui4 碳tan4 磁ci2 磅bang4
祈qi2 祖zu3 祥xiang2 禁jin4 禽qin2 秀xiu4 私si1 秩zhi4 积ji1
称cheng1 移yi2 稍shao1 稚zhi4 稳wen3 稿gao3 穆mu4 穴xue2 究jiu1
窃qie4 窍qiao4 窝wo1 竖shu4 竭jie2 端duan1 笼long2 筋jin1 筑zhu4
筒tong3 策ce4 签qian1 简jian3 籍ji2 粒li4 粘zhan1 粹cui4 紧jin3
素su4 索suo3 紫zi3 累lei4 繁fan2 纠jiu1 纤xian1 纳na4 纵zong4
纷fen1 纹wen2 绅shen1 绍shao4 绎yi4 络luo4 绚xuan4 绩ji4 绪xu4
绳sheng2 综zong1 缀zhui4 缅mian3 缆lan3 缔di4 编bian1 缠chan2
缩suo1 缸gang1 缴jiao3 罕han3 罢ba4 罩zhao4 罪zui4 羞xiu1 群qun2
翁weng1 翔xiang2 翼yi4 耀yao4 耍shua3 耗hao4 耽dan1 聆ling2 聘pin4
聚ju4 肃su4 肆si4 肖xiao4 肯ken3 胁xie2 胆dan3 胜sheng4 胞bao1
脉mai4 脱tuo1 腾teng2 膜mo2 臣chen2 致zhi4 舆yu2 舒shu1 艘sou1
艰jian1 芬fen1 芳fang1 苍cang1 苗miao2 茂mao4 茫mang2 荒huang1
荐jian4 莫mo4 菲fei1 萌meng2 萧xiao1 葬zang4 蒙meng2 蓬peng2
蔑mie4 蔽bi4 薄bo2 虎hu3 虑lv4 虚xu1 虫chong2 虹hong2 蚀shi2
蛮man2 融rong2 衡heng2 衬chen4 衷zhong1 袖xiu4 裂lie4 裕yu4
裤ku4 裹guo3 誉yu4 誓shi4 譬pi4 贞zhen1 负fu4 贡gong4 贤xian2
贩fan4 贪tan1 贫pin2 贯guan4 贴tie1 贸mao4 贺he4 赋fu4 赌du3
赔pei2 赖lai4 赞zan4 赠zeng4 赤chi4 赫he4 趁chen4 趟tang4 跃yue4
践jian4 跻ji1 踊yong3 蹄ti2 蹲dun1 躁zao4 辅fu3 辈bei4 辉hui1
辑ji2 辖xia2 辛xin1 辟pi4 辨bian4 辩bian4 辽liao2 迁qian1 迎ying2
迫po4 述shu4 迷mi2 迹ji4 适shi4 逊xun4 递di4 逗dou4 逝shi4
逼bi1 遂sui4 遏e4 遗yi2 遵zun1 邀yao1 邦bang1 邪xie2 郁yu4
郊jiao1 郎lang2 酌zhuo2 酬chou2 酷ku4 释shi4 鉴jian4 锁suo3
锐rui4 锦jin3 镇zhen4 镶xiang1 闭bi4 闷men4 闸zha2 阅yue4 阐chan3
阻zu3 附fu4 陆lu4 陋lou4 降jiang4 陕shan3 陡dou3 除chu2 陷xian4
隆long2 隙xi4 障zhang4 隶li4 雄xiong2 雅ya3 雇gu4 雕diao1 零ling2
雾wu4 需xu1 震zhen4 霸ba4 靡mi3 靠kao4 鞠ju1 韧ren4 频pin2
颁ban1 颂song4 预yu4 颇po1 颈jing3 颤chan4 饥ji1 饰shi4 饲si4
馈kui4 馨xin1 驳bo2 驰chi2 驻zhu4 骄jiao1 骤zhou4 魂hun2 魅mei4
魄po4 鲁lu3 鸣ming2 鸿hong2 麦mai4 默mo4 鼎ding3 齿chi3 龄ling2
护hu4 础chu3 互hu4 临lin2 顿dun4 释shi4 丰feng1 举ju3 乌wu1 乏fa2
乔qiao2 习xi2 乡xiang1 予yu3 争zheng1 亡wang2 享xiang3 亭ting2
仍reng2 仔zai3 仗zhang4 付fu4 仙xian1 仪yi2 仿fang3 企qi3 伍wu3
伏fu2 伐fa2 休xiu1 众zhong4 伟wei3 伸shen1 伺ci4 佩pei4 佳jia1
侈chi3 侍shi4 侠xia2 侮wu3 促cu4 俄e2 俊jun4 俘fu2 俱ju4 倦juan4
偎wei1 偿chang2 兄xiong1 兢jing1 兹zi1 养yang3 兰lan2 冀ji4 冈gang1
冗rong3 冤yuan1 冬dong1 凄qi1 准zhun3 凌ling2 凛lin3 凶xiong1
判pan4 利li4 删shan1 刮gua1 制zhi4 刹cha4 剃ti4 剑jian4 剥bo1
剧ju4 劈pi1 功gong1 加jia1 务wu4 劣lie4 动dong4 助zhu4 勃bo2
勘kan1 募mu4 勤qin2 勿wu4 包bao1 匆cong1 匠jiang4 匪fei3 区qu1
医yi1 午wu3 卉hui4 半ban4 华hua2 协xie2 博bo2 厦sha4 去qu4 叁san1
参can1 叉cha1 及ji2 友you3 双shuang1 叙xu4 叟sou3 叫jiao4 叭ba5
吁yu4 吉ji2 吊diao4 吕lv3 君jun1 吞tun1 吧ba5 含han2 启qi3 吵chao3
吻wen3 吼hou3 呀ya5 呕ou3 员yuan2 呜wu1 周zhou1 味wei4 呼hu1
命ming4 和he2 咕gu1 咬yao3 哀ai1 品pin3 哄hong3 哆duo1 哈ha1
响xiang3 哦o4 哼heng1 唐tang2 售shou4 唷yo5 唸nian4 啄zhuo2 啸xiao4
喘chuan3 喻yu4 嗅xiu4 嗡weng1 嗷ao2 嘀di2 嘲chao2 嘴zui3 噪zao4
"""

CHAR_READINGS: dict[str, str] = {}
# Round-2 supplement: misses found by register-probe (tech/sports/weather/
# social registers).
_DATA8 = """
借jie4 域yu4 景jing3 漫man4 租zu1 练lian4 署shu3 良liang2 训xun4 访fang3
链lian4 食shi2 聊liao2 逛guang4 晒shai4 赞zan4 圈quan1 博bo2 晋jin4 衔xian2
峰feng1 巅dian1 谷gu3 涯ya2 岸an4 滩tan1 礁jiao1 湾wan1 屿yu3 疆jiang1
"""

for _tok in (
    _DATA + _DATA2 + _DATA3 + _DATA4 + _DATA5 + _DATA6 + _DATA7 + _DATA8
).split():
    if len(_tok) >= 2 and "一" <= _tok[0] <= "鿿":
        CHAR_READINGS.setdefault(_tok[0], _tok[1:])

# Multi-character words whose per-character defaults would be wrong
# (heteronyms) — matched longest-first before character lookup.
PHRASE_READINGS: dict[str, str] = {
    "银行": "yin2hang2", "行长": "hang2zhang3", "行业": "hang2ye4",
    "自行车": "zi4xing2che1", "行动": "xing2dong4",
    "长大": "zhang3da4", "成长": "cheng2zhang3", "校长": "xiao4zhang3",
    "长度": "chang2du4", "长城": "chang2cheng2", "市长": "shi4zhang3",
    "增长": "zeng1zhang3", "会长": "hui4zhang3", "队长": "dui4zhang3",
    "音乐": "yin1yue4", "乐器": "yue4qi4", "乐队": "yue4dui4",
    "快乐": "kuai4le4", "乐趣": "le4qu4",
    "重要": "zhong4yao4", "重复": "chong2fu4", "重新": "chong2xin1",
    "重庆": "chong2qing4",
    "还是": "hai2shi4", "还有": "hai2you3", "归还": "gui1huan2",
    "还给": "huan2gei3", "还款": "huan2kuan3",
    "觉得": "jue2de5", "睡觉": "shui4jiao4", "午觉": "wu3jiao4",
    "了解": "liao3jie3", "了不起": "liao3bu4qi3",
    "着急": "zhao2ji2", "着火": "zhao2huo3", "穿着": "chuan1zhuo2",
    "地方": "di4fang5", "土地": "tu3di4", "慢慢地": "man4man4de5",
    "得到": "de2dao4", "获得": "huo4de2", "我得": "wo3dei3",
    "发现": "fa1xian4", "头发": "tou2fa4", "理发": "li3fa4",
    "好像": "hao3xiang4", "爱好": "ai4hao4", "好奇": "hao4qi2",
    "为了": "wei4le5", "因为": "yin1wei4", "为什么": "wei4shen2me5",
    "成为": "cheng2wei2", "作为": "zuo4wei2", "认为": "ren4wei2",
    "行为": "xing2wei2", "以为": "yi3wei2",
    "便宜": "pian2yi5", "方便": "fang1bian4",
    "都市": "du1shi4", "首都": "shou3du1", "都会": "du1hui4",
    "教书": "jiao1shu1", "教学": "jiao1xue2",
    "得很": "de5hen3",
    "干净": "gan1jing4", "干燥": "gan1zao4", "干部": "gan4bu4",
    "干活": "gan4huo2",
    "数学": "shu4xue2", "数数": "shu3shu4", "无数": "wu2shu4",
    "种地": "zhong4di4", "种植": "zhong4zhi2", "种子": "zhong3zi5",
    "只有": "zhi3you3", "一只": "yi4zhi1", "只能": "zhi3neng2",
    "调查": "diao4cha2", "空调": "kong1tiao2", "调整": "tiao2zheng3",
    "调节": "tiao2jie2",
    "差不多": "cha4bu5duo1", "出差": "chu1chai1", "差别": "cha1bie2",
    "差异": "cha1yi4",
    "弹琴": "tan2qin2", "子弹": "zi3dan4", "弹簧": "tan2huang2",
    "假期": "jia4qi1", "放假": "fang4jia4", "假如": "jia3ru2",
    "假设": "jia3she4",
    "倒是": "dao4shi4", "倒车": "dao4che1", "摔倒": "shuai1dao3",
    "倒下": "dao3xia4",
    "背包": "bei1bao1", "背后": "bei4hou4", "背景": "bei4jing3",
    "相信": "xiang1xin4", "照相": "zhao4xiang4", "相机": "xiang4ji1",
    "首相": "shou3xiang4",
    "省钱": "sheng3qian2", "反省": "fan3xing3", "省会": "sheng3hui4",
    "朝鲜": "chao2xian3", "朝阳": "zhao1yang2", "朝代": "chao2dai4",
    "朝天": "chao2tian1",
    "传记": "zhuan4ji4", "传说": "chuan2shuo1",
    "分钟": "fen1zhong1", "分数": "fen1shu4", "部分": "bu4fen5",
    "十分": "shi2fen1", "身份": "shen1fen4",
    "处理": "chu3li3", "处于": "chu3yu2", "到处": "dao4chu4",
    "好处": "hao3chu4", "相处": "xiang1chu3",
    "答应": "da1ying5", "回答": "hui2da2",
    "应该": "ying1gai1", "应用": "ying4yong4", "反应": "fan3ying4",
    "适应": "shi4ying4",
    "中间": "zhong1jian1", "中奖": "zhong4jiang3", "打中": "da3zhong4",
    "看见": "kan4jian4", "看守": "kan1shou3", "看护": "kan1hu4",
    "少年": "shao4nian2", "多少": "duo1shao3", "少女": "shao4nv3",
    "老少": "lao3shao4",
    "尽管": "jin3guan3", "尽量": "jin3liang4", "尽力": "jin4li4",
    "几乎": "ji1hu1", "几个": "ji3ge4", "茶几": "cha2ji1",
    "奇怪": "qi2guai4", "奇数": "ji1shu4",
    "干吗": "gan4ma2",
    "漂亮": "piao4liang5", "漂流": "piao1liu2",
    "没有": "mei2you3", "淹没": "yan1mo4", "没收": "mo4shou1",
    "血液": "xue4ye4", "流血": "liu2xue4",
    "大夫": "dai4fu5", "丈夫": "zhang4fu5", "功夫": "gong1fu5",
    "结实": "jie1shi5", "结果": "jie2guo3", "结婚": "jie2hun1",
    "系鞋带": "ji4xie2dai4", "关系": "guan1xi5", "系统": "xi4tong3",
    "恶心": "e3xin1", "可恶": "ke3wu4", "恶劣": "e4lie4",
    "似的": "shi4de5", "相似": "xiang1si4", "类似": "lei4si4",
    "弟兄": "di4xiong1", "兄弟": "xiong1di4",
    "东西": "dong1xi5", "西瓜": "xi1gua1",
    "喇叭": "la3ba5",
    "咳嗽": "ke2sou5",
    "玫瑰": "mei2gui5",
    "知识": "zhi1shi5", "认识": "ren4shi5", "标识": "biao1zhi4",
    "意思": "yi4si5",
    "衣服": "yi1fu5", "舒服": "shu1fu5", "佩服": "pei4fu2",
    "馒头": "man2tou5", "石头": "shi2tou5", "木头": "mu4tou5",
    "什么": "shen2me5", "怎么": "zen3me5", "这么": "zhe4me5",
    "那么": "na4me5", "多么": "duo1me5",
    "朋友": "peng2you5", "眼睛": "yan3jing5", "耳朵": "er3duo5",
    "鼻子": "bi2zi5", "嘴巴": "zui3ba5", "脑袋": "nao3dai5",
    "桌子": "zhuo1zi5", "椅子": "yi3zi5", "孩子": "hai2zi5",
    "儿子": "er2zi5", "妻子": "qi1zi5", "房子": "fang2zi5",
    "村子": "cun1zi5", "样子": "yang4zi5", "日子": "ri4zi5",
    "裤子": "ku4zi5", "鞋子": "xie2zi5", "帽子": "mao4zi5",
    "筷子": "kuai4zi5", "杯子": "bei1zi5", "瓶子": "ping2zi5",
    "先生": "xian1sheng5", "学生": "xue2sheng5", "医生": "yi1sheng1",
    "时候": "shi2hou5", "时间": "shi2jian1",
    "妈妈": "ma1ma5", "爸爸": "ba4ba5", "哥哥": "ge1ge5",
    "姐姐": "jie3jie5", "弟弟": "di4di5", "妹妹": "mei4mei5",
    "爷爷": "ye2ye5", "奶奶": "nai3nai5", "叔叔": "shu1shu5",
    "阿姨": "a1yi2",
    "谢谢": "xie4xie5", "再见": "zai4jian4",
}

# longest-first match order, precomputed once at import
PHRASE_KEYS = sorted(PHRASE_READINGS, key=len, reverse=True)
MAX_PHRASE_LEN = max(map(len, PHRASE_READINGS)) if PHRASE_READINGS else 0
